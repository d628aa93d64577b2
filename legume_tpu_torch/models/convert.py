"""Weights across the two packages, in the flat `"a/b/c"` layout that
`save_model` writes (flax's `flatten_dict(variables, sep="/")`).

- `params/encoder/trunk/fc{i}/kernel [in, out]` <-> `trunk.fc.{i}.weight
  [out, in]` (transposed); `bias` <-> `bias`; the same for `z_mean` and
  `z_lnvar`;
- `params/encoder/trunk/bn_z/{scale, bias}` and
  `batch_stats/encoder/trunk/bn_z/{mean, var}` <-> the port's BatchNorm
  `weight`, `bias`, `running_mean`, `running_var`;
- `params/decoder_{i}/dictionary/dictionary [K, D]` and
  `params/decoder_{i}/log_phi [1, D]` carry over as they are.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_ENC = "params/encoder/trunk/"
_BN = "batch_stats/encoder/trunk/bn_z/"
_LINEAR = re.compile(r"^(fc(\d+)|z_mean|z_lnvar)/(kernel|bias)$")


def params_from_jax(variables: dict) -> tuple[dict, list[dict]]:
    """Flat `{"a/b/c": array}` -> (encoder state_dict, [decoder state_dict
    per level])."""
    enc: dict[str, torch.Tensor] = {}
    decs: dict[int, dict[str, torch.Tensor]] = {}
    for name, value in variables.items():
        arr = torch.from_numpy(np.array(value, np.float32))
        if name.startswith(_ENC):
            rest = name[len(_ENC):]
            if rest.startswith("bn_z/"):
                enc[{"bn_z/scale": "trunk.bn_z.weight", "bn_z/bias": "trunk.bn_z.bias"}[rest]] = arr
                continue
            m = _LINEAR.match(rest)
            if m is None:
                raise KeyError(f"unknown encoder parameter {name}")
            layer = f"fc.{m.group(2)}" if m.group(2) is not None else m.group(1)
            is_kernel = m.group(3) == "kernel"
            enc[f"trunk.{layer}.{'weight' if is_kernel else 'bias'}"] = arr.T.contiguous() if is_kernel else arr
        elif name.startswith(_BN):
            enc[{"mean": "trunk.bn_z.running_mean", "var": "trunk.bn_z.running_var"}[name[len(_BN):]]] = arr
        else:
            m = re.match(r"^params/decoder_(\d+)/(dictionary/dictionary|log_phi)$", name)
            if m is None:
                raise KeyError(f"unknown parameter {name}")
            decs.setdefault(int(m.group(1)), {})[m.group(2).split("/")[0]] = arr
    return enc, [decs[i] for i in sorted(decs)]


def params_to_jax(encoder_state: dict, decoder_states: list[dict]) -> dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: flat `{"a/b/c": array}`."""
    flat: dict[str, np.ndarray] = {}
    for key, t in encoder_state.items():
        arr = t.detach().cpu().numpy()
        parts = key.split(".")  # trunk.<layer>[.i].<param>
        if parts[1] == "bn_z":
            name = {
                "weight": _ENC + "bn_z/scale", "bias": _ENC + "bn_z/bias",
                "running_mean": _BN + "mean", "running_var": _BN + "var",
            }[parts[2]]
            flat[name] = arr
            continue
        layer = f"fc{parts[2]}" if parts[1] == "fc" else parts[1]
        if parts[-1] == "weight":
            flat[f"{_ENC}{layer}/kernel"] = np.ascontiguousarray(arr.T)
        else:
            flat[f"{_ENC}{layer}/bias"] = arr
    for i, state in enumerate(decoder_states):
        flat[f"params/decoder_{i}/dictionary/dictionary"] = state["dictionary"].detach().cpu().numpy()
        flat[f"params/decoder_{i}/log_phi"] = state["log_phi"].detach().cpu().numpy()
    return flat
