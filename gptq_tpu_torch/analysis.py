"""Sensitivity analysis tooling (port of gptq_tpu/analysis.py):
  * per-linear GPTQ.analyse() stats collection over a model
  * the columnwise-vs-rowwise decision rule -> a per-module quant-config
    JSON (what --quant_config reads)
  * per-module proxy-loss records (the sensitivity/*.txt format) and
    their comparison / plotting helpers (matplotlib optional).
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from gptq_tpu_torch.models.common import ArchSpec, build_mask, embed_forward
from gptq_tpu_torch.models.registry import get_arch
from gptq_tpu_torch.pipeline import _layer_scan
from gptq_tpu_torch.quant.gptq import GPTQ


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


@torch.no_grad()
def analyse_model(spec: ArchSpec, params: dict, calib_ids: torch.Tensor,
                  log: Callable[[str], None] = print) -> dict:
    """Run GPTQ.analyse per linear over the whole model, layer by layer
    (each layer's inputs are the previous layer's outputs on the dense
    weights). calib_ids: (nsamples, seqlen) token ids on the params'
    device. Returns {module_path: analyse-dict of numpy arrays} with
    row / column stats of W, W*a, W/diag(Hinv)."""
    arch = get_arch(spec.arch)
    nsamples, T = calib_ids.shape
    dev = calib_ids.device
    positions = torch.arange(T, device=dev)[None]
    mask = build_mask(spec, T, T, dev)
    inps = torch.stack([embed_forward(spec, params, calib_ids[j:j + 1],
                                      positions)[0]
                        for j in range(nsamples)])
    results = {}
    for i, bp in enumerate(params["layers"]):
        names = tuple(n for n, key in arch.linears.items() if key in bp)
        outs, hstates = _layer_scan(spec, bp, inps, positions, mask, names)
        for name in names:
            w = bp[arch.linears[name]]["w"]
            g = GPTQ(w.to(dev))
            g.state = hstates[name]
            results[f"{arch.hf_prefix}.{i}.{name}"] = _numpy(g.analyse())
        inps = outs
        log(f"analysed layer {i}")
    return results


def derive_quant_config(analysis: dict, bits: int = 3,
                        out_path: str | None = None) -> dict:
    """Columnwise-vs-rowwise decision from range/std comparison: a module
    whose column-wise weight ranges are more uniform than its row-wise
    ranges quantizes better columnwise."""
    cfg = {}
    for name, st in analysis.items():
        row_range = st["rowwise"]["w"]["max"] - st["rowwise"]["w"]["min"]
        col_range = st["columnWise"]["w"]["max"] - st["columnWise"]["w"]["min"]
        columnwise = bool(np.std(col_range) < np.std(row_range))
        cfg[name] = {"bits": bits, "columnwise": columnwise}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(cfg, f, indent=2)
    return cfg


def save_sensitivity_log(losses: dict, path: str) -> None:
    """Append per-module proxy losses in the sensitivity/*.txt format
    ('0.self_attn.k_proj: 53833.6')."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        for name, loss in losses.items():
            short = ".".join(name.split(".")[-3:])
            f.write(f"{short}: {loss}\n")


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without it."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001 -- plotting is optional
        return None
    return plt


def plot_sensitivity(losses: dict, out_png: str, title: str = "") -> bool:
    """Bar chart of per-module loss. Returns False when matplotlib is
    unavailable."""
    plt = _pyplot()
    if plt is None:
        return False
    names = list(losses)
    vals = [losses[n] for n in names]
    fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.25), 4))
    ax.bar(range(len(names)), vals)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels([n.split(".", 3)[-1] for n in names], rotation=90,
                       fontsize=5)
    ax.set_ylabel("GPTQ proxy loss")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return True


def plot_sensitivity_diff(losses_a: dict, losses_b: dict, out_png: str,
                          label_a: str = "a", label_b: str = "b") -> bool:
    """Per-module loss difference bars."""
    plt = _pyplot()
    if plt is None:
        return False
    names = [n for n in losses_a if n in losses_b]
    diffs = [losses_a[n] - losses_b[n] for n in names]
    fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.25), 4))
    ax.bar(range(len(names)), diffs,
           color=["tab:red" if d > 0 else "tab:green" for d in diffs])
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels([n.split(".", 3)[-1] for n in names], rotation=90,
                       fontsize=5)
    ax.set_ylabel(f"loss({label_a}) - loss({label_b})")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return True


def plot_distribution2d(W, out_png: str) -> bool:
    """Weight-distribution heatmap."""
    plt = _pyplot()
    if plt is None:
        return False
    W = np.asarray(W)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(np.abs(W), aspect="auto", cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("in features")
    ax.set_ylabel("out features")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return True


def plot_distribution3d(W, out_png: str, max_cells: int = 64) -> bool:
    """3-D magnitude surface of a weight / activation matrix, block-max
    downsampled to at most max_cells per axis."""
    plt = _pyplot()
    if plt is None:
        return False
    W = np.abs(np.asarray(W, dtype=np.float32))
    for axis in (0, 1):
        n = W.shape[axis]
        if n > max_cells:
            step = -(-n // max_cells)
            pad = (-n) % step
            Wp = np.pad(W, [(0, pad), (0, 0)] if axis == 0 else
                        [(0, 0), (0, pad)])
            if axis == 0:
                W = Wp.reshape(-1, step, Wp.shape[1]).max(axis=1)
            else:
                W = Wp.reshape(Wp.shape[0], -1, step).max(axis=2)
    x, y = np.meshgrid(np.arange(W.shape[1]), np.arange(W.shape[0]))
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(x, y, W, cmap="viridis")
    ax.set_xlabel("in features")
    ax.set_ylabel("out features")
    ax.set_zlabel("|w|")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return True
