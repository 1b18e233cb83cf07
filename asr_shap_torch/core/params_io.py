"""Flat ``.npz`` params archives, read into torch tensors and written back.

The archive format is the reference package's: leaves keyed by their tree
path joined with ``::`` (list items as ``#i``), plus an optional
``__asr_shap_config__`` entry holding the architecture config as JSON. The
reference stacks the encoder layers along a leading axis; the port keeps
one dict per layer in ``params["encoder"]["layers"]`` (the Wav2Vec2
families: Wav2Vec2's attention/ffn/norms, or the conformer's attn, conv,
ffn1, ffn2 and final_norm) and in the top-level ``params["layers"]`` (the
mel Conformer's). All other leaves keep the reference layouts: conv
kernels ``[K, C_in, C_out]`` (the conformers' depthwise kernel
``[K, 1, D]``, the mel subsampler's 2-D kernels ``[3, 3, C_in, C_out]``),
linears ``[in, out]``. ``StateDictReader`` reads a torch ``state_dict``
into those layouts for the checkpoint converters.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from asr_shap_torch.core import config as config_mod
from asr_shap_torch.core.device import resolve_device

logger = logging.getLogger(__name__)

_SEP = "::"
_CONFIG_KEY = "__asr_shap_config__"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix[: -len(_SEP)]] = np.asarray(tree)
    return out


def map_leaves(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(v, fn) for v in tree]
    return fn(tree)


def _unstack_layers(stacked: Any) -> list:
    """Stacked per-layer leaves (leading axis = layer) -> one tree per layer."""
    leaves = _flatten(stacked)
    n = next(iter(leaves.values())).shape[0]
    layers = []
    for i in range(n):
        layer: Dict[str, Any] = {}
        for path, arr in leaves.items():
            node = layer
            parts = path.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr[i]
        layers.append(layer)
    return layers


def params_from_jax(tree: Any, device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Reference-package params (a tree of numpy arrays, layers stacked) ->
    port params (float32 tensors on ``device``, one dict per layer)."""
    device = resolve_device(device)
    tree = map_leaves(tree, np.asarray)
    out = dict(tree)
    if "layers" in tree:
        out["layers"] = _unstack_layers(tree["layers"])
    if "encoder" in tree and "layers" in tree["encoder"]:
        out["encoder"] = dict(tree["encoder"])
        out["encoder"]["layers"] = _unstack_layers(tree["encoder"]["layers"])

    def to_tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device)  # a writable copy

    return map_leaves(out, to_tensor)


def _stack_layers(layers: list) -> Dict[str, Any]:
    """One tree per layer -> stacked leaves (leading axis = layer), the
    inverse of ``_unstack_layers``."""
    flat = [_flatten(layer) for layer in layers]
    stacked: Dict[str, Any] = {}
    for path in flat[0]:
        node = stacked
        parts = path.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.stack([f[path] for f in flat])
    return stacked


def params_to_jax(params: Any) -> Dict[str, Any]:
    """Port params -> the reference package's tree: numpy leaves on the
    host, layers stacked (the inverse of ``params_from_jax``)."""
    tree = map_leaves(params, lambda t: t.detach().cpu().numpy()
                       if isinstance(t, torch.Tensor) else np.asarray(t))
    if "layers" in tree:
        tree["layers"] = _stack_layers(tree["layers"])
    if "encoder" in tree and "layers" in tree["encoder"]:
        tree["encoder"] = dict(tree["encoder"])
        tree["encoder"]["layers"] = _stack_layers(tree["encoder"]["layers"])
    return tree


def save_params(path: str, params: Any, config: Any = None) -> None:
    """Write port params as a reference-format archive (``params_to_jax``,
    leaves flattened by tree path). ``config``: a config dataclass to embed
    (class name + fields as JSON), or None for a weights-only archive.
    Either package loads the result."""
    flat = _flatten(params_to_jax(params))
    if config is not None:
        payload = {"class": type(config).__name__,
                   "fields": dataclasses.asdict(config)}
        flat[_CONFIG_KEY] = np.frombuffer(json.dumps(payload).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_config(path: str) -> Optional[Any]:
    """The embedded config dataclass, or None for weights-only archives.
    Fields the current dataclass does not know are dropped with a warning;
    fields added since the save keep their defaults."""
    data = np.load(path)
    if _CONFIG_KEY not in data.files:
        return None
    payload = json.loads(bytes(data[_CONFIG_KEY]).decode())
    cls = getattr(config_mod, payload["class"], None)
    if cls is None:
        raise ValueError(
            f"{path}: config class {payload['class']!r} is not ported yet "
            "(the port has Wav2Vec2Config, Wav2Vec2ConformerConfig and ConformerConfig)"
        )
    known = {f.name for f in dataclasses.fields(cls)}
    fields, dropped = {}, []
    for k, v in payload["fields"].items():
        if k in known:
            fields[k] = tuple(v) if isinstance(v, list) else v
        else:
            dropped.append(k)
    if dropped:
        logger.warning("%s: ignoring config fields unknown to %s (%s)",
                       path, cls.__name__, ", ".join(dropped))
    return cls(**fields)


def load_params(path: str, device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Read an archive into port params on ``device``."""
    data = np.load(path)
    tree: Dict[str, Any] = {}
    for key in data.files:
        if key == _CONFIG_KEY:
            continue
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                return [listify(node[f"#{i}"]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return params_from_jax(listify(tree), device)


class StateDictReader:
    """Leaves of one torch ``state_dict`` as float32 tensors on ``device``,
    in the port's layouts. A linear or conv whose bias is missing gets none,
    or zeros with ``zero_bias``."""

    def __init__(self, sd: Mapping[str, Any], device: torch.device, zero_bias: bool = False):
        self.sd, self.device, self.zero_bias = sd, device, zero_bias

    def array(self, key: str) -> np.ndarray:
        t = self.sd[key]
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    def tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

    def get(self, key: str) -> torch.Tensor:
        return self.tensor(self.array(key))

    def _with_bias(self, kernel: np.ndarray, prefix: str) -> Dict[str, Any]:
        p = {"kernel": self.tensor(kernel)}
        if f"{prefix}.bias" in self.sd:
            p["bias"] = self.get(f"{prefix}.bias")
        elif self.zero_bias:
            p["bias"] = self.tensor(np.zeros(kernel.shape[-1]))
        return p

    def linear(self, prefix: str) -> Dict[str, Any]:
        """Linear [out, in] -> kernel [in, out]."""
        return self._with_bias(self.array(f"{prefix}.weight").T, prefix)

    def pointwise(self, prefix: str) -> Dict[str, Any]:
        """Conv1d of kernel 1 [out, in, 1] -> a linear kernel [in, out]."""
        return self._with_bias(self.array(f"{prefix}.weight")[:, :, 0].T, prefix)

    def conv1d(self, prefix: str) -> Dict[str, Any]:
        """Conv1d [out, in/groups, K] -> kernel [K, in/groups, out]."""
        return self._with_bias(self.array(f"{prefix}.weight").transpose(2, 1, 0), prefix)

    def norm(self, prefix: str) -> Dict[str, Any]:
        return {"scale": self.get(f"{prefix}.weight"), "bias": self.get(f"{prefix}.bias")}
