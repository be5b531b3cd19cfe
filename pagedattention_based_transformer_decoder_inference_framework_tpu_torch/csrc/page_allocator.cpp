// Native page allocator: free list, refcounted COW forks, LRU reuse of
// freed prefix-cache pages.
//
// C++ twin of kvcache/allocator.py (same semantics, bit for bit), a
// host-side library (no device code) built by g++ at first use into the
// package's _build/ and loaded through ctypes (kvcache/native.py). The
// device page table is a tensor of block tables; the allocator
// bookkeeping that feeds it stays native so scheduler admission at high
// request rates is not Python-bound. Eviction never touches live pages:
// alloc fails (-1) when only live pages remain, and only *freed* pages
// are recycled in LRU order.
//
// Single-threaded by design (owned by the scheduler).

#include <cstdint>
#include <list>
#include <unordered_map>
#include <vector>

namespace {

struct Allocator {
  int num_pages;
  std::vector<int> free_stack;                  // plain free pages
  std::unordered_map<int, int> refs;            // live page -> refcount
  // freed-but-reusable pages in LRU order (front = oldest) with their
  // content tag, plus a tag index for prefix-cache lookup
  std::list<std::pair<int, int64_t>> lru;       // (page, tag)
  std::unordered_map<int, std::list<std::pair<int, int64_t>>::iterator>
      lru_pos;
  std::unordered_multimap<int64_t, int> by_tag;

  explicit Allocator(int n) : num_pages(n) {
    free_stack.reserve(n > 0 ? n - 1 : 0);
    for (int p = 1; p < n; ++p) free_stack.push_back(p);
    // stack top = page 1 (matches the Python allocator's pop order)
    for (int i = 0, j = (int)free_stack.size() - 1; i < j; ++i, --j)
      std::swap(free_stack[i], free_stack[j]);
  }

  void drop_from_lru(int page) {
    auto it = lru_pos.find(page);
    if (it == lru_pos.end()) return;
    int64_t tag = it->second->second;
    auto range = by_tag.equal_range(tag);
    for (auto t = range.first; t != range.second; ++t)
      if (t->second == page) { by_tag.erase(t); break; }
    lru.erase(it->second);
    lru_pos.erase(it);
  }

  int alloc() {
    int page;
    if (!free_stack.empty()) {
      page = free_stack.back();
      free_stack.pop_back();
    } else if (!lru.empty()) {
      page = lru.front().first;                 // evict oldest freed page
      drop_from_lru(page);
    } else {
      return -1;
    }
    refs[page] = 1;
    return page;
  }
};

}  // namespace

extern "C" {

void* pa_create(int num_pages) { return new Allocator(num_pages); }

void pa_destroy(void* h) { delete static_cast<Allocator*>(h); }

int pa_num_free(void* h) {
  auto* a = static_cast<Allocator*>(h);
  return (int)(a->free_stack.size() + a->lru.size());
}

int pa_num_live(void* h) {
  return (int)static_cast<Allocator*>(h)->refs.size();
}

int pa_alloc(void* h) { return static_cast<Allocator*>(h)->alloc(); }

// Fills out[0..n); returns 0, or -1 (and allocates nothing) if fewer
// than n pages are free.
int pa_alloc_many(void* h, int n, int* out) {
  auto* a = static_cast<Allocator*>(h);
  if (n > pa_num_free(h)) return -1;
  for (int i = 0; i < n; ++i) out[i] = a->alloc();
  return 0;
}

// has_tag=0: plain free. Returns 0, or -1 on double free.
int pa_free(void* h, int page, int64_t tag, int has_tag) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->refs.find(page);
  if (it == a->refs.end()) return -1;
  if (it->second > 1) {
    --it->second;
    return 0;
  }
  a->refs.erase(it);
  if (has_tag) {
    a->lru.emplace_back(page, tag);
    a->lru_pos[page] = std::prev(a->lru.end());
    a->by_tag.emplace(tag, page);
  } else {
    a->free_stack.push_back(page);
  }
  return 0;
}

// Increfs every page (beam fork). Returns 0, or -1 if any page is not
// live (no increfs are applied in that case).
int pa_fork(void* h, const int* pages, int n) {
  auto* a = static_cast<Allocator*>(h);
  for (int i = 0; i < n; ++i)
    if (a->refs.find(pages[i]) == a->refs.end()) return -1;
  for (int i = 0; i < n; ++i) ++a->refs[pages[i]];
  return 0;
}

int pa_refcount(void* h, int page) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->refs.find(page);
  return it == a->refs.end() ? 0 : it->second;
}

// *out_page = writable page. Returns 1 if a COW copy is needed (fresh
// page allocated, shared page decreffed), 0 if already exclusive,
// -1 on error (page not live, or pool exhausted for the copy).
int pa_ensure_exclusive(void* h, int page, int* out_page) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->refs.find(page);
  if (it == a->refs.end()) return -1;
  if (it->second == 1) {
    *out_page = page;
    return 0;
  }
  int fresh = a->alloc();
  if (fresh < 0) return -1;
  --a->refs[page];
  *out_page = fresh;
  return 1;
}

int pa_num_cached(void* h) {
  return (int)static_cast<Allocator*>(h)->lru.size();
}

// Force-claim a specific page id (KV-snapshot restore): incref if live,
// else remove from free/LRU with refcount 1. Returns 0, -1 if unknown.
int pa_claim(void* h, int page) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->refs.find(page);
  if (it != a->refs.end()) {
    ++it->second;
    return 0;
  }
  if (a->lru_pos.count(page)) {
    a->drop_from_lru(page);
  } else {
    bool found = false;
    for (std::size_t i = 0; i < a->free_stack.size(); ++i)
      if (a->free_stack[i] == page) {
        a->free_stack.erase(a->free_stack.begin() + i);
        found = true;
        break;
      }
    if (!found) return -1;
  }
  a->refs[page] = 1;
  return 0;
}

// Grow/shrink the managed range. Shrinking requires all dropped pages
// free; returns 0, or -1 (unchanged) if a live page would be dropped.
int pa_resize(void* h, int new_num_pages) {
  auto* a = static_cast<Allocator*>(h);
  if (new_num_pages > a->num_pages) {
    for (int p = a->num_pages; p < new_num_pages; ++p)
      a->free_stack.push_back(p);
  } else {
    for (int p = new_num_pages; p < a->num_pages; ++p)
      if (a->refs.count(p)) return -1;
    for (int p = new_num_pages; p < a->num_pages; ++p) {
      if (a->lru_pos.count(p)) {
        a->drop_from_lru(p);
      } else {
        for (std::size_t i = 0; i < a->free_stack.size(); ++i)
          if (a->free_stack[i] == p) {
            a->free_stack.erase(a->free_stack.begin() + i);
            break;
          }
      }
    }
  }
  a->num_pages = new_num_pages;
  return 0;
}

// Invalidate the whole prefix cache: every freed-but-tagged page moves
// to the plain free list (used after a device-state reset makes cached
// page contents stale). Returns the number of pages dropped.
int pa_drop_cached(void* h) {
  auto* a = static_cast<Allocator*>(h);
  int n = (int)a->lru.size();
  for (auto& e : a->lru) a->free_stack.push_back(e.first);
  a->lru.clear();
  a->lru_pos.clear();
  a->by_tag.clear();
  return n;
}

// Reclaim a freed page with matching content tag. Returns page id or -1.
int pa_lookup_freed(void* h, int64_t tag) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->by_tag.find(tag);
  if (it == a->by_tag.end()) return -1;
  int page = it->second;
  a->drop_from_lru(page);
  a->refs[page] = 1;
  return page;
}

}  // extern "C"
