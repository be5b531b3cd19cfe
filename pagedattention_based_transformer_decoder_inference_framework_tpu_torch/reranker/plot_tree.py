"""Beam-tree visualization: the hypotheses of a beam search as a prefix
tree, drawn with matplotlib and networkx where both are installed, else
printed as text."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def build_tree(beams: Sequence[Tuple[Sequence[int], float]]):
    """Edges of the prefix tree over beam token sequences."""
    edges = set()
    for tokens, _score in beams:
        prev = ("root",)
        for t in tokens:
            node = prev + (t,)
            edges.add((prev, node))
            prev = node
    return sorted(edges, key=lambda e: (len(e[0]), str(e)))


def render_ascii(beams: Sequence[Tuple[Sequence[int], float]],
                 decode=None) -> str:
    lines = ["beam tree:"]
    for tokens, score in beams:
        text = decode(tokens) if decode else " ".join(map(str, tokens))
        lines.append(f"  [{score:8.3f}] {text}")
    return "\n".join(lines)


def plot_tree(beams: Sequence[Tuple[Sequence[int], float]],
              path: str = "beam_tree.png", decode=None) -> Optional[str]:
    """A PNG at ``path`` via networkx/matplotlib if present (returns the
    path), else the text tree on stdout (returns None)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import networkx as nx
    except ImportError:
        print(render_ascii(beams, decode))
        return None

    g = nx.DiGraph()
    for a, b in build_tree(beams):
        label = str(b[-1]) if decode is None else decode([b[-1]])
        g.add_edge(a, b, label=label)
    pos = nx.spring_layout(g, seed=0)
    plt.figure(figsize=(12, 8))
    nx.draw(g, pos, node_size=60, arrows=False)
    nx.draw_networkx_edge_labels(
        g, pos, edge_labels=nx.get_edge_attributes(g, "label"), font_size=6)
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()
    return path
