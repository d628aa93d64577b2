"""Weights across the two packages, in the flat `"a/b/c"` layout that
`save_model` writes (flax's `flatten_dict(variables, sep="/")`).

- `params/encoder/trunk/fc{i}/kernel [in, out]` <-> `trunk.fc.{i}.weight
  [out, in]` (transposed); `bias` <-> `bias`; the same for `z_mean` and
  `z_lnvar`;
- `params/encoder/trunk/bn_z/{scale, bias}` and
  `batch_stats/encoder/trunk/bn_z/{mean, var}` <-> the port's BatchNorm
  `weight`, `bias`, `running_mean`, `running_var`;
- a level's decoder: `params/decoder_{i}/dictionary/dictionary [K, D]`
  <-> `dictionary`, and `log_phi [1, D]` (nb, nb-mixture), `log_alpha
  [1, D]`, `rho_a [1, 1]`, `rho_b [1, 1]` (nb-mixture) as they are;
- a level with several decoder families: family `j` of level `i` under
  `params/decoder_{i}/{j}/...`. (The JAX package's `save_model` writes
  such a level as one pickled object array, which its own `load_model`
  cannot read; this layout unflattens into a dict there.)
"""

from __future__ import annotations

import re

import numpy as np
import torch

_ENC = "params/encoder/trunk/"
_BN = "batch_stats/encoder/trunk/bn_z/"
_LINEAR = re.compile(r"^(fc(\d+)|z_mean|z_lnvar)/(kernel|bias)$")
_DEC = re.compile(
    r"^params/decoder_(\d+)/(?:(\d+)/)?(dictionary/dictionary|log_phi|log_alpha|rho_a|rho_b)$"
)


def params_from_jax(variables: dict) -> tuple[dict, list]:
    """Flat `{"a/b/c": array}` -> (encoder state_dict, per level a decoder
    state_dict, or a list of them for a level with several families)."""
    enc: dict[str, torch.Tensor] = {}
    decs: dict[int, dict] = {}
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
            m = _DEC.match(name)
            if m is None:
                raise KeyError(f"unknown parameter {name}")
            family = None if m.group(2) is None else int(m.group(2))
            decs.setdefault(int(m.group(1)), {}).setdefault(family, {})[m.group(3).split("/")[0]] = arr
    levels = []
    for i in sorted(decs):
        fams = decs[i]
        if None in fams:
            if len(fams) > 1:
                raise KeyError(f"decoder_{i} mixes a single decoder with families")
            levels.append(fams[None])
        else:
            levels.append([fams[j] for j in sorted(fams)])
    return enc, levels


def _decoder_flat(prefix: str, state: dict) -> dict[str, np.ndarray]:
    return {
        f"{prefix}/dictionary/dictionary" if key == "dictionary" else f"{prefix}/{key}":
            t.detach().cpu().numpy()
        for key, t in state.items()
    }


def params_to_jax(encoder_state: dict, decoder_states: list) -> dict[str, np.ndarray]:
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
        if isinstance(state, (list, tuple)):
            for j, fam in enumerate(state):
                flat.update(_decoder_flat(f"params/decoder_{i}/{j}", fam))
        else:
            flat.update(_decoder_flat(f"params/decoder_{i}", state))
    return flat
