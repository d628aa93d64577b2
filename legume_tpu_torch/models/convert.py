"""Weights across the two packages, in the flat `"a/b/c"` layout that
`save_model` writes (flax's `flatten_dict(variables, sep="/")`).

Dense models (`senna topic`, `vae`, `joint-topic`):

- `params/encoder/trunk/fc{i}/kernel [in, out]` <-> `trunk.fc.{i}.weight
  [out, in]` (transposed); `bias` <-> `bias`; the same for `z_mean` and
  `z_lnvar`; the joint encoder's trunk of modality m is `mod{m}` there
  and `trunks.{m}` here;
- `params/encoder/<trunk>/bn_z/{scale, bias}` and
  `batch_stats/encoder/<trunk>/bn_z/{mean, var}` <-> the port's
  BatchNorm `weight`, `bias`, `running_mean`, `running_var`;
- a level's decoder: `params/decoder_{i}/dictionary/dictionary [K, D]`
  <-> `dictionary`; `log_phi [1, D]` (nb, nb-mixture, gaussian-nb),
  `log_alpha [1, D]`, `rho_a [1, 1]`, `rho_b [1, 1]` (nb-mixture) as they
  are; gaussian-nb's `dictionary/kernel [K, D]` and `dictionary/bias [D]`
  <-> `dictionary.kernel`, `dictionary.bias`; the delta decoder's `base`
  and `delta_{m}` as they are;
- a level with several decoders (families, or `joint-topic`'s one per
  modality): decoder `j` of level `i` under `params/decoder_{i}/{j}/...`.
  (The JAX package's `save_model` writes such a level as one pickled
  object array, which its own `load_model` cannot read; this layout
  unflattens into a dict there.)

The two modules no command builds, from their own variables (names
without the model's `encoder/` level): `IafSoftmaxEncoder`'s `trunk/...`
as above, `iaf{i}/w_ar` <-> `flows.{i}.w_ar`, `iaf{i}/{ctx, m, s}` and
`h_proj` as Dense layers (kernel transposed; the autoregressive mask is
a constant of the port's layer, not a parameter of either); the
`BipartiteDecoder`'s `coupling [K, K]` and `feature [K, D]` as they are,
by `iaf_params_from_jax` and `bipartite_params_from_jax`.

Masked models (`masked-topic`, `masked-vae`, `masked-sbp`): `params/rho`,
`alpha`, `log_phi`, `theta_readout/{kernel, bias}` and the indexed
encoder's `Dense_0` (hidden), `BatchNorm_0`, `Dense_1` (mean), `Dense_2`
(log variance) and `module_centroids`, by `masked_params_from_jax` /
`masked_params_to_jax`.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_ENC = "params/encoder/"
_BN_STATS = "batch_stats/encoder/"
_TRUNK = re.compile(r"^(trunk|mod(\d+))/(.*)$")
_LINEAR = re.compile(r"^(fc(\d+)|z_mean|z_lnvar)/(kernel|bias)$")
_DEC = re.compile(
    r"^params/decoder_(\d+)/(?:(\d+)/)?(dictionary/dictionary|dictionary/kernel|dictionary/bias"
    r"|log_phi|log_alpha|rho_a|rho_b|base|delta_\d+)$"
)
_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}
_BN_INV = {v: k for k, v in {**_BN_PARAM, **_BN_STAT}.items()}


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, np.float32))


def _trunk_prefix(name: str, where: str) -> tuple[str, str]:
    """(`trunk.` or `trunks.{m}.`, the rest) of `trunk/...` or `mod{m}/...`."""
    m = _TRUNK.match(name)
    if m is None:
        raise KeyError(f"unknown encoder parameter {where}")
    return ("trunk." if m.group(2) is None else f"trunks.{m.group(2)}."), m.group(3)


def _dec_key(name: str) -> str:
    return {"dictionary/dictionary": "dictionary", "dictionary/kernel": "dictionary.kernel",
            "dictionary/bias": "dictionary.bias"}.get(name, name)


def params_from_jax(variables: dict) -> tuple[dict, list]:
    """Flat `{"a/b/c": array}` -> (encoder state_dict, per level a decoder
    state_dict, or a list of them for a level with several decoders)."""
    enc: dict[str, torch.Tensor] = {}
    decs: dict[int, dict] = {}
    for name, value in variables.items():
        arr = _tensor(value)
        if name.startswith(_ENC):
            prefix, rest = _trunk_prefix(name[len(_ENC):], name)
            if rest.startswith("bn_z/"):
                enc[prefix + "bn_z." + _BN_PARAM[rest[len("bn_z/"):]]] = arr
                continue
            m = _LINEAR.match(rest)
            if m is None:
                raise KeyError(f"unknown encoder parameter {name}")
            layer = f"fc.{m.group(2)}" if m.group(2) is not None else m.group(1)
            is_kernel = m.group(3) == "kernel"
            enc[f"{prefix}{layer}.{'weight' if is_kernel else 'bias'}"] = (
                arr.T.contiguous() if is_kernel else arr)
        elif name.startswith(_BN_STATS):
            prefix, rest = _trunk_prefix(name[len(_BN_STATS):], name)
            if not rest.startswith("bn_z/"):
                raise KeyError(f"unknown batch statistic {name}")
            enc[prefix + "bn_z." + _BN_STAT[rest[len("bn_z/"):]]] = arr
        else:
            m = _DEC.match(name)
            if m is None:
                raise KeyError(f"unknown parameter {name}")
            family = None if m.group(2) is None else int(m.group(2))
            decs.setdefault(int(m.group(1)), {}).setdefault(family, {})[_dec_key(m.group(3))] = arr
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
    inv = {"dictionary": "dictionary/dictionary", "dictionary.kernel": "dictionary/kernel",
           "dictionary.bias": "dictionary/bias"}
    return {f"{prefix}/{inv.get(key, key)}": t.detach().cpu().numpy() for key, t in state.items()}


def params_to_jax(encoder_state: dict, decoder_states: list) -> dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: flat `{"a/b/c": array}`."""
    flat: dict[str, np.ndarray] = {}
    for key, t in encoder_state.items():
        arr = t.detach().cpu().numpy()
        parts = key.split(".")  # trunk.<layer>[.i].<param> or trunks.<m>.<layer>[.i].<param>
        if parts[0] == "trunks":
            trunk, parts = f"mod{parts[1]}", parts[2:]
        else:
            trunk, parts = "trunk", parts[1:]
        if parts[0] == "bn_z":
            where = _BN_STATS if parts[1].startswith("running_") else _ENC
            flat[f"{where}{trunk}/bn_z/{_BN_INV[parts[1]]}"] = arr
            continue
        layer = f"fc{parts[1]}" if parts[0] == "fc" else parts[0]
        if parts[-1] == "weight":
            flat[f"{_ENC}{trunk}/{layer}/kernel"] = np.ascontiguousarray(arr.T)
        else:
            flat[f"{_ENC}{trunk}/{layer}/bias"] = arr
    for i, state in enumerate(decoder_states):
        if isinstance(state, (list, tuple)):
            for j, fam in enumerate(state):
                flat.update(_decoder_flat(f"params/decoder_{i}/{j}", fam))
        else:
            flat.update(_decoder_flat(f"params/decoder_{i}", state))
    return flat


# ---- IAF encoder, bipartite decoder -------------------------------------------

_IAF = re.compile(r"^(?:iaf(\d+)/(w_ar|ctx|m|s)|(h_proj))(?:/(kernel|bias))?$")


def _dense_entry(layer: str, leaf: str, arr: torch.Tensor) -> tuple[str, torch.Tensor]:
    return (f"{layer}.weight", arr.T.contiguous()) if leaf == "kernel" else (f"{layer}.bias", arr)


def iaf_params_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """Flat `{"a/b/c": array}` of the JAX package's `IafSoftmaxEncoder`
    (`flatten_dict(variables, sep="/")`) -> the port's state_dict."""
    state: dict[str, torch.Tensor] = {}
    for name, value in variables.items():
        arr = _tensor(value)
        kind, _, rest = name.partition("/")
        if kind == "batch_stats" and rest.startswith("trunk/bn_z/"):
            state["trunk.bn_z." + _BN_STAT[rest[len("trunk/bn_z/"):]]] = arr
            continue
        if kind != "params":
            raise KeyError(f"unknown IAF encoder variable {name}")
        if rest.startswith("trunk/"):
            sub = rest[len("trunk/"):]
            if sub.startswith("bn_z/"):
                state["trunk.bn_z." + _BN_PARAM[sub[len("bn_z/"):]]] = arr
                continue
            m = _LINEAR.match(sub)
            if m is None:
                raise KeyError(f"unknown IAF encoder parameter {name}")
            layer = f"fc.{m.group(2)}" if m.group(2) is not None else m.group(1)
            key, t = _dense_entry(f"trunk.{layer}", m.group(3), arr)
        else:
            m = _IAF.match(rest)
            if m is None or (m.group(2) == "w_ar") != (m.group(4) is None):
                raise KeyError(f"unknown IAF encoder parameter {name}")
            if m.group(2) == "w_ar":
                key, t = f"flows.{m.group(1)}.w_ar", arr
            else:
                layer = "h_proj" if m.group(3) else f"flows.{m.group(1)}.{m.group(2)}"
                key, t = _dense_entry(layer, m.group(4), arr)
        state[key] = t
    return state


def bipartite_params_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """Flat `{"params/coupling": R, "params/feature": F}` of the JAX
    package's `BipartiteDecoder` -> the port's state_dict."""
    state = {}
    for name, value in variables.items():
        if name not in ("params/coupling", "params/feature"):
            raise KeyError(f"unknown bipartite decoder parameter {name}")
        state[name[len("params/"):]] = _tensor(value)
    return state


# ---- masked (indexed) models ------------------------------------------------

_MASKED_DENSE = {"Dense_0": "encoder.hidden", "Dense_1": "encoder.z_mean",
                 "Dense_2": "encoder.z_lnvar"}


def masked_params_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """Flat `{"a/b/c": array}` of a masked model -> its state_dict."""
    state: dict[str, torch.Tensor] = {}
    for name, value in variables.items():
        arr = _tensor(value)
        parts = name.split("/")
        if parts[0] == "batch_stats" and parts[1:3] == ["encoder", "BatchNorm_0"]:
            state[f"encoder.bn.{_BN_STAT[parts[3]]}"] = arr
        elif parts[0] != "params":
            raise KeyError(f"unknown masked-model variable {name}")
        elif parts[1] in ("rho", "alpha", "log_phi") and len(parts) == 2:
            state[parts[1]] = arr
        elif parts[1] == "theta_readout" or (parts[1] == "encoder" and parts[2] in _MASKED_DENSE):
            layer = "theta_readout" if parts[1] == "theta_readout" else _MASKED_DENSE[parts[2]]
            is_kernel = parts[-1] == "kernel"
            state[f"{layer}.{'weight' if is_kernel else 'bias'}"] = (
                arr.T.contiguous() if is_kernel else arr)
        elif parts[1:3] == ["encoder", "BatchNorm_0"]:
            state[f"encoder.bn.{_BN_PARAM[parts[3]]}"] = arr
        elif parts[1:3] == ["encoder", "module_centroids"]:
            state["encoder.module_centroids"] = arr
        else:
            raise KeyError(f"unknown masked-model parameter {name}")
    return state


def masked_params_to_jax(state: dict) -> dict[str, np.ndarray]:
    """The inverse of `masked_params_from_jax`."""
    dense = {v: k for k, v in _MASKED_DENSE.items()}
    flat: dict[str, np.ndarray] = {}
    for key, t in state.items():
        arr = t.detach().cpu().numpy()
        head, _, leaf = key.rpartition(".")
        if key in ("rho", "alpha", "log_phi"):
            flat[f"params/{key}"] = arr
        elif key == "encoder.module_centroids":
            flat["params/encoder/module_centroids"] = arr
        elif head == "encoder.bn":
            where = "batch_stats" if leaf.startswith("running_") else "params"
            flat[f"{where}/encoder/BatchNorm_0/{_BN_INV[leaf]}"] = arr
        else:
            where = "params/theta_readout" if head == "theta_readout" else f"params/encoder/{dense[head]}"
            flat[f"{where}/{'kernel' if leaf == 'weight' else 'bias'}"] = (
                np.ascontiguousarray(arr.T) if leaf == "weight" else arr)
    return flat


# ---- SGVB variational families (models/sgvb.py) ------------------------------

_SGVB_FAMILIES = ("GaussianVarParams", "SpikeSlabVarParams", "SusieVarParams",
                  "BiSusieVarParams", "MlSusieVarParams", "AshVarParams")


def sgvb_params_from_jax(q, device="cpu"):
    """A JAX package `q` (any of its SGVB family NamedTuples, fields as
    arrays) -> the port's NamedTuple of the same name and fields, float32
    tensors on `device`."""
    from . import sgvb

    name = type(q).__name__
    if name not in _SGVB_FAMILIES:
        raise KeyError(f"unknown SGVB family {name}")
    return getattr(sgvb, name)(*(_tensor(np.asarray(v)).to(device) for v in q))


def sgvb_params_to_jax(q) -> tuple[str, dict[str, np.ndarray]]:
    """The inverse of `sgvb_params_from_jax`: (the family's class name,
    `{field: float32 array}`), from which the JAX package's NamedTuple of
    that name is built."""
    name = type(q).__name__
    if name not in _SGVB_FAMILIES:
        raise KeyError(f"unknown SGVB family {name}")
    return name, {f: v.detach().cpu().numpy() for f, v in zip(q._fields, q)}
