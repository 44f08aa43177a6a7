"""IISPTNet weights in the flax checkpoint format, both ways.

The format is the flat npz that the JAX package's trainer writes
(``ml/train.py::save_pretrained``): keys ``params/Conv_i/{kernel,bias}``
(kernels HWIO), ``params/ConvTranspose_i/{kernel,bias}``,
``params/BatchNorm_i/{scale,bias}`` and ``batch_stats/BatchNorm_i/{mean,var}``,
stored as float16 and widened to float32 on reading as the reference's
loader does.  ``flax_from_state_dict`` and ``save_pretrained`` write the
same trees and file from an ``IISPTNet``, so the JAX package's
``load_pretrained`` reads what the port trains.  Files are read and
written with numpy; nothing of the JAX package is imported.  A missing
file raises: there is no random-weight fallback.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .iisptnet import IISPTNet

DEFAULT_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "pbrt_v3_iile_tpu", "ml", "pretrained", "iispt_pretrained.npz")


def _unflatten(flat: dict) -> dict:
    tree = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v, np.float32)
    return tree


def _conv_weight(kernel_hwio):
    """HWIO -> OIHW, unflipped (flax's ConvTranspose at stride 1 included)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel_hwio, np.float32).transpose(3, 2, 0, 1)))


def state_dict_from_flax(variables: dict) -> dict:
    """{"params": ..., "batch_stats": ...} of numpy arrays -> the
    state_dict of ``IISPTNet``."""
    params, stats = variables["params"], variables["batch_stats"]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())
    sd = {}
    for name, prefix in (("Conv", "conv"), ("ConvTranspose", "convt")):
        i = 0
        while f"{name}_{i}" in params:
            p = params[f"{name}_{i}"]
            sd[f"{prefix}.{i}.weight"] = _conv_weight(p["kernel"])
            sd[f"{prefix}.{i}.bias"] = t(p["bias"])
            i += 1
    i = 0
    while f"BatchNorm_{i}" in params:
        p, s = params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"]
        sd[f"bn.{i}.weight"] = t(p["scale"])
        sd[f"bn.{i}.bias"] = t(p["bias"])
        sd[f"bn.{i}.running_mean"] = t(s["mean"])
        sd[f"bn.{i}.running_var"] = t(s["var"])
        sd[f"bn.{i}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        i += 1
    return sd


def flax_from_state_dict(sd: dict) -> dict:
    """``IISPTNet`` state_dict -> {"params": ..., "batch_stats": ...}: nested
    dicts of float32 numpy arrays under flax's names (HWIO kernels)."""
    a = lambda t: t.detach().to("cpu", torch.float32).numpy().copy()
    params, stats = {}, {}
    for name, prefix in (("Conv", "conv"), ("ConvTranspose", "convt")):
        i = 0
        while f"{prefix}.{i}.weight" in sd:
            params[f"{name}_{i}"] = {
                "kernel": a(sd[f"{prefix}.{i}.weight"]).transpose(2, 3, 1, 0).copy(),
                "bias": a(sd[f"{prefix}.{i}.bias"])}
            i += 1
    i = 0
    while f"bn.{i}.weight" in sd:
        params[f"BatchNorm_{i}"] = {"scale": a(sd[f"bn.{i}.weight"]),
                                    "bias": a(sd[f"bn.{i}.bias"])}
        stats[f"BatchNorm_{i}"] = {"mean": a(sd[f"bn.{i}.running_mean"]),
                                   "var": a(sd[f"bn.{i}.running_var"])}
        i += 1
    return {"params": params, "batch_stats": stats}


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def save_pretrained(path: str, variables: dict):
    """Write flax-style variables ({"params", "batch_stats"}) as the flat
    float16 npz of the JAX package's ``ml/train.py::save_pretrained``."""
    flat = _flatten({top: variables[top] for top in ("params", "batch_stats")})
    np.savez_compressed(path, **{k: v.astype(np.float16) for k, v in flat.items()})


def iisptnet_from_flax(variables: dict) -> IISPTNet:
    """An eval-mode ``IISPTNet`` (on the CPU) holding flax variables; the
    width K is read from the first convolution."""
    k = int(np.shape(variables["params"]["Conv_0"]["kernel"])[-1])
    net = IISPTNet(k=k)
    net.load_state_dict(state_dict_from_flax(variables))
    return net.eval()


def load_iisptnet_npz(path: str = None) -> dict:
    """Read a flat npz checkpoint -> ``IISPTNet`` state_dict.  The default
    is the committed pretrained model; a missing file raises."""
    path = DEFAULT_NPZ if path is None else path
    if not os.path.exists(path):
        raise FileNotFoundError(f"IISPTNet weights not found: {path}")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return state_dict_from_flax(_unflatten(flat))


def load_iisptnet(path: str = None, device="cuda") -> IISPTNet:
    """The eval-mode net with the weights of ``path`` on ``device`` (the
    card unless the caller asks for the CPU)."""
    sd = load_iisptnet_npz(path)
    net = IISPTNet(k=sd["conv.0.weight"].shape[0])
    net.load_state_dict(sd)
    return net.eval().to(device)
