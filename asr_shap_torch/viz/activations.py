"""Activation-function documentation figures: response curves for ReLU,
SiLU, sigmoid, GELU and the GLU gate, the DeepSHAP rescale multiplier
against the local gradient (the quantity ``explain/deepshap.py``
substitutes in the backward), and GLU's computation graph (networkx,
optional)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from asr_shap_torch.viz.static import pyplot


def plot_activation_curves(out_path: Optional[str] = "activation_curves.png"):
    plt = pyplot()
    x = np.linspace(-5, 5, 400)
    sig = 1 / (1 + np.exp(-x))
    curves = {
        "ReLU": np.maximum(x, 0),
        "SiLU": x * sig,
        "sigmoid": sig,
        "GELU": 0.5 * x * (1 + _erf(x / np.sqrt(2))),
    }
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    for name, y in curves.items():
        axes[0].plot(x, y, label=name)
    axes[0].legend()
    axes[0].set_title("activations")
    axes[0].grid(alpha=0.3)

    # GLU response slice: a * sigmoid(b) for a in {-1, 0.5, 1, 2}
    b = np.linspace(-5, 5, 400)
    for a in (-1.0, 0.5, 1.0, 2.0):
        axes[1].plot(b, a / (1 + np.exp(-b)), label=f"GLU, a={a}")
    axes[1].legend()
    axes[1].set_title("GLU gate response a·σ(b)")
    axes[1].set_xlabel("gate input b")
    axes[1].grid(alpha=0.3)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def plot_rescale_multipliers(out_path: Optional[str] = "rescale_multipliers.png"):
    """The DeepLIFT rescale multiplier (f(x)-f(r))/(x-r) against the local
    gradient, for SiLU with r = 0."""
    plt = pyplot()
    x = np.linspace(-5, 5, 400)
    r = 0.0

    def silu(v):
        return v / (1 + np.exp(-v))

    def dsilu(v):
        return (1 + np.exp(-v) + v * np.exp(-v)) / (1 + np.exp(-v)) ** 2

    mult = np.where(np.abs(x - r) > 1e-6, (silu(x) - silu(r)) / (x - r), dsilu(x))
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(x, dsilu(x), label="local gradient f'(x)")
    ax.plot(x, mult, label="rescale multiplier (f(x)-f(0))/x")
    ax.legend()
    ax.grid(alpha=0.3)
    ax.set_title("SiLU: gradient vs DeepLIFT rescale multiplier (ref=0)")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def plot_glu_graph(out_path: Optional[str] = "glu_graph.png"):
    """Computation-graph diagram of GLU; None where networkx does not
    import."""
    plt = pyplot()
    try:
        import networkx as nx
    except Exception:
        return None

    g = nx.DiGraph()
    g.add_edges_from([
        ("x", "split"), ("split", "a"), ("split", "b"),
        ("b", "sigmoid"), ("a", "multiply"), ("sigmoid", "multiply"),
        ("multiply", "out"),
    ])
    pos = {
        "x": (0, 1), "split": (1, 1), "a": (2, 1.6), "b": (2, 0.4),
        "sigmoid": (3, 0.4), "multiply": (4, 1), "out": (5, 1),
    }
    fig, ax = plt.subplots(figsize=(9, 3.5))
    nx.draw_networkx(g, pos, ax=ax, node_color="#cfe8ff", node_size=2200,
                     font_size=9, arrows=True)
    ax.set_title("GLU(x) = a ⊙ σ(b),  [a, b] = split(x)")
    ax.axis("off")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def _erf(x):
    from scipy.special import erf

    return erf(x)
