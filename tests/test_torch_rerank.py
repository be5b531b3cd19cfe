"""The PyTorch port's reranker (``reranker/``), the engine's
``score_candidates_nll`` it scores with, and the CLI's ``rerank`` and
``build_jsonl``, against the JAX package's on the same bridged weights
(the JAX engine in interpret mode, the port on the CPU): scores within
1e-4 (f32 sums in another order), and the JAX ``tests/test_beam_rerank.py``
reranker cases on the port. The cross-encoder runs on a tiny random BERT
built in code (nothing is downloaded).
"""

import json

import numpy as np
import pytest

import jax

from pagedattention_based_transformer_decoder_inference_framework_tpu.reranker import (
    LogProbScorer as JaxLogProbScorer,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.cli import (
    cli_app,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    SamplingParams,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.reranker import (
    CrossEncoderScorer,
    LogProbScorer,
    Reranker,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.reranker.export_jsonl import (
    export_jsonl,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.reranker.plot_tree import (
    build_tree,
    render_ascii,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.utils.tokenizer import (
    get_tokenizer,
)

from test_torch_beam import build

GREEDY = SamplingParams(temperature=0.0, eos_token_id=-1)
TOL = dict(atol=1e-4, rtol=1e-4)
CTX = [3, 5, 7, 9, 11, 2, 4, 6, 8, 1, 3]          # crosses a page (8)
CANDS = [[7, 7], [1, 2, 3, 4, 5], [9]]


@pytest.fixture(scope="module")
def engines():
    return build("llama-tiny", "float32")


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


def test_score_candidates_nll_matches_jax_and_separate_scoring(engines):
    """The context prefilled once, candidate rows sharing its pages: equal
    to the JAX engine's and to scoring each ``context + candidate`` row
    alone with ``score_nll``; no page stays live."""
    je, te = engines
    free_before = te.allocator.num_free
    for mean in (False, True):
        got = te.score_candidates_nll(CTX, CANDS, mean=mean)
        np.testing.assert_allclose(
            got, je.score_candidates_nll(CTX, CANDS, mean=mean), **TOL)
        want = np.array([te.score_nll([CTX + c], starts=[len(CTX)],
                                      mean=mean)[0] for c in CANDS])
        np.testing.assert_allclose(got, want, **TOL)
    assert te.allocator.num_free == free_before


def test_score_candidates_nll_frees_pages_on_error(engine, monkeypatch):
    """A failure after the pages are taken leaves none live."""
    from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache.allocator import (
        PageAllocator,
    )

    alloc = PageAllocator(engine.cache.num_pages)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(engine, "_nll_chunks", boom)
    with pytest.raises(RuntimeError, match="injected"):
        engine.score_candidates_nll(CTX, CANDS, allocator=alloc)
    assert alloc.num_live == 0


def test_logprob_scorer_matches_jax(engines):
    je, te = engines
    for norm in (True, False):
        got = LogProbScorer(te, length_normalize=norm).score_batch(CTX, CANDS)
        want = JaxLogProbScorer(je, length_normalize=norm).score_batch(
            CTX, CANDS)
        np.testing.assert_allclose(got, want, **TOL)


def test_logprob_scorer_batch_matches_single(engine):
    """score_batch == per-candidate score (both normalizations), empty
    candidates at -inf."""
    ctx = [2, 4, 6, 8, 10]
    cands = [[5, 3], [], [1, 1, 1]]
    for norm in (True, False):
        s = LogProbScorer(engine, length_normalize=norm)
        batch = s.score_batch(ctx, cands)
        assert batch[1] == float("-inf")
        for i in (0, 2):
            assert abs(batch[i] - s.score(ctx, cands[i])) < 1e-4


def test_logprob_scorer_prefers_model_continuation(engine):
    prompt = [2, 4, 6, 8]
    greedy = engine.generate(prompt, 4, GREEDY)
    rng = np.random.default_rng(0)
    random_cand = [int(t) for t in rng.integers(0, engine.cfg.vocab_size, 4)]
    rr = Reranker(LogProbScorer(engine))
    scores = rr.rerank_scores(prompt, [greedy, random_cand])
    assert scores[0] > scores[1]
    assert rr.select_best(prompt, [random_cand, greedy]) == 1


def test_reranker_select_best_api():
    class Fixed:
        def score(self, ctx, cand):
            return float(len(cand))

    rr = Reranker(Fixed())
    assert rr.select_best([1], [[1], [1, 2, 3], [1, 2]]) == 1


def test_cross_encoder_scorer_wired_end_to_end(tmp_path):
    """A local HF sequence-classification model (a random tiny BERT built
    here) plugs into the id-based Reranker: ids decode to text through the
    framework tokenizer and score through the classifier."""
    import torch
    from transformers import BertConfig, BertForSequenceClassification

    path = tmp_path / "tiny-cross-encoder"
    torch.manual_seed(0)
    BertForSequenceClassification(BertConfig(
        vocab_size=64, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=64, num_labels=2)).save_pretrained(path)

    class ByteHFTok:
        """An HF tokenizer's call: the bytes of the text pair."""

        def __call__(self, a, b, **kw):
            ids = ([2] + [c % 64 for c in a.encode()[:20]]
                   + [3] + [c % 64 for c in b.encode()[:20]])
            return {"input_ids": torch.tensor([ids]),
                    "attention_mask": torch.ones((1, len(ids)),
                                                 dtype=torch.long)}

    byte = get_tokenizer("byte")
    scorer = CrossEncoderScorer(str(path), tokenizer=ByteHFTok(),
                                id_tokenizer=byte, device="cpu")
    rr = Reranker(scorer)
    ctx = byte.encode("the quick brown fox")
    cands = [byte.encode(t)
             for t in ("jumps over", "sells seashells", "jumps over it")]
    scores = rr.rerank_scores(ctx, cands)
    assert len(scores) == 3 and all(0.0 <= s <= 1.0 for s in scores)
    assert rr.select_best(ctx, cands) == int(np.argmax(scores))
    assert abs(scores[0] - scorer.score_text("the quick brown fox",
                                             "jumps over")) < 1e-6
    with pytest.raises(ValueError, match="id_tokenizer"):
        CrossEncoderScorer(str(path), tokenizer=ByteHFTok(),
                           device="cpu").score([1], [2])


def test_cross_encoder_runs_where_asked(tmp_path, monkeypatch, capsys):
    """The cross-encoder runs on ``cuda`` unless the caller asks for the
    CPU, and raises without a card (never a silent fall-back); the CLI's
    ``rerank --scorer cross-encoder`` passes ``--device`` on. The model is
    a random tiny BERT with a word-piece vocabulary written here."""
    import torch
    from transformers import (BertConfig, BertForSequenceClassification,
                              BertTokenizer)

    path = tmp_path / "tiny-cross-encoder"
    path.mkdir()
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello",
             "there", "friend", "x"] + [chr(c) for c in range(97, 123)]
    (path / "vocab.txt").write_text("\n".join(words) + "\n")
    BertTokenizer(str(path / "vocab.txt")).save_pretrained(path)
    torch.manual_seed(0)
    BertForSequenceClassification(BertConfig(
        vocab_size=len(words), hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=64, num_labels=2)).save_pretrained(path)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CrossEncoderScorer(str(path))
    scorer = CrossEncoderScorer(str(path), device="cpu")
    assert scorer.device == torch.device("cpu")
    assert next(scorer.model.parameters()).device == torch.device("cpu")
    want = [scorer.score_text("hello there", c)
            for c in ("friend", "x", "there")]
    assert cli_app.main([
        "rerank", "--model", "llama-tiny", "--device", "cpu",
        "--scorer", "cross-encoder", "--reranker-model", str(path),
        "--context", "hello there", "--candidates", "friend", "x",
        "there"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and sum(x.startswith("*") for x in lines) == 1
    got = [float(x.split("[")[1].split("]")[0]) for x in lines]
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_app.main([
            "rerank", "--model", "llama-tiny", "--scorer", "cross-encoder",
            "--reranker-model", str(path), "--context", "hello",
            "--candidates", "x"])


def test_export_and_tree(tmp_path):
    rows = [{"context": "a", "candidate": "b", "label": 1},
            {"context": "a", "candidate": "c", "label": 0}]
    path = tmp_path / "rows.jsonl"
    assert export_jsonl(rows, str(path)) == 2
    assert [json.loads(x) for x in path.read_text().splitlines()] == rows
    beams = [([1, 2, 3], -1.5), ([1, 2, 4], -2.0)]
    edges = build_tree(beams)
    assert len(edges) == 4 and edges[0] == (("root",), ("root", 1))
    assert "-1.500" in render_ascii(beams)


def test_cli_rerank_and_build_jsonl(tmp_path, capsys):
    """``rerank`` marks the best-scored candidate; ``build_jsonl`` writes
    each prompt's beam hypotheses, one labelled best."""
    common = ["--model", "llama-tiny", "--device", "cpu",
              "--max-new-tokens", "4"]
    assert cli_app.main(["rerank", *common, "--context", "hello there",
                         "--candidates", "friend", "zq#", "x"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and sum(x.startswith("*") for x in lines) == 1
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("hello\n\nabc def\n")
    out = tmp_path / "train.jsonl"
    assert cli_app.main(["build_jsonl", *common, "--prompts", str(prompts),
                         "--out", str(out), "--beam-width", "2"]) == 0
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["context"] for r in rows] == ["hello"] * 2 + ["abc def"] * 2
    for ctx in ("hello", "abc def"):
        assert sum(r["label"] for r in rows if r["context"] == ctx) == 1
    assert "wrote 4 rows" in capsys.readouterr().out
