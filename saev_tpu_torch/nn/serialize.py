"""SAE checkpoint serialization, byte-compatible with the reference format (the
counterpart of saev_tpu/nn/serialize.py).

One file: a JSON header line {schema: 5, cfg, commit, lib} followed by raw
`torch.save(state_dict)` bytes of float32 `W_enc`, `b_enc`, `W_dec` and
`b_dec` (reference modeling.py:549-574), so a file from either package, or
the reference, loads in the other; `load` migrates the five historical
schema generations (modeling.py:578-658) with `cfg_from_header`.

State-dict key map (state dict -> params/state):
    W_enc (d_model, d_sae)       -> params["W_enc"]
    b_enc (d_sae,)               -> params["b_enc"]
    W_dec (d_sae, d_model)       -> params["W_dec"]
    b_dec (d_model,)             -> params["b_dec"]
    activation.threshold scalar  -> state["threshold"]   (BatchTopK only)
"""

import dataclasses
import io
import json
import pathlib
import typing as tp

import torch

from .. import guards, helpers
from . import modeling

SCHEMA_VERSION = 5


# ---------------------------------------------------------------------------
# Activation-config (de)serialization — the {"cls": ..., "params": {...}} format
# of reference modeling.py:466-545.
# ---------------------------------------------------------------------------


def _serialize_value(value: tp.Any) -> tp.Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return serialize_dataclass(value)
    if isinstance(value, (tuple, list)):
        return [_serialize_value(v) for v in value]
    if isinstance(value, dict):
        return {k: _serialize_value(v) for k, v in value.items()}
    return value


def serialize_dataclass(obj: tp.Any) -> dict[str, tp.Any]:
    assert dataclasses.is_dataclass(obj), f"Cannot serialize non-dataclass: {type(obj)}"
    params = {
        f.name: _serialize_value(getattr(obj, f.name)) for f in dataclasses.fields(obj)
    }
    return {"cls": obj.__class__.__name__, "params": params}


_ACTIVATION_CLASSES: dict[str, type] = {
    cls.__name__: cls
    for cls in (
        modeling.NoSparsity,
        modeling.L1Sparsity,
        modeling.NoAux,
        modeling.AuxK,
        modeling.Relu,
        modeling.TopK,
        modeling.BatchTopK,
    )
}


def _deserialize_legacy_sparsity(payload: dict[str, tp.Any]):
    """Pre-dataclass sparsity dicts: {} -> NoSparsity, {"coeff": c} -> L1Sparsity
    (reference modeling.py:538-545)."""
    if not payload:
        return modeling.NoSparsity()
    if set(payload.keys()) <= {"coeff"}:
        return modeling.L1Sparsity(**payload)
    return None


def _deserialize_value(value: tp.Any, *, field_name: str, allow_legacy_nested: bool):
    if isinstance(value, dict):
        if "cls" in value and "params" in value:
            return deserialize_dataclass_payload(
                value, allow_legacy_nested=allow_legacy_nested
            )
        if allow_legacy_nested and field_name == "sparsity":
            legacy = _deserialize_legacy_sparsity(value)
            if legacy is not None:
                return legacy
        return {
            k: _deserialize_value(
                v, field_name=field_name, allow_legacy_nested=allow_legacy_nested
            )
            for k, v in value.items()
        }
    if isinstance(value, list):
        return [
            _deserialize_value(
                item, field_name=field_name, allow_legacy_nested=allow_legacy_nested
            )
            for item in value
        ]
    return value


def deserialize_dataclass_payload(
    payload: dict[str, tp.Any], *, allow_legacy_nested: bool = False
):
    cls_name = payload["cls"]
    cls = _ACTIVATION_CLASSES.get(cls_name)
    assert cls is not None, f"Unknown activation class '{cls_name}' in payload."
    params: dict[str, tp.Any] = {}
    for key_raw, value in payload["params"].items():
        # Legacy field name "kind" -> "key" (reference modeling.py:498).
        key = "key" if key_raw == "kind" else key_raw
        assert key not in params, (
            f"Duplicate key '{key}' after legacy normalization for class '{cls_name}'."
        )
        params[key] = _deserialize_value(
            value, field_name=key, allow_legacy_nested=allow_legacy_nested
        )
    return cls(**params)


def _normalize_cfg_kwargs(cfg_dict: dict[str, tp.Any]) -> dict[str, tp.Any]:
    """Drop removed fields; migrate exp_factor -> d_sae (reference modeling.py:449-462)."""
    cfg = dict(cfg_dict)
    cfg.pop("n_reinit_samples", None)
    cfg.pop("seed", None)
    if "exp_factor" in cfg and "d_sae" not in cfg:
        exp_factor = cfg.pop("exp_factor")
        d_model = cfg.get("d_model")
        if d_model is None:
            raise ValueError(
                "Cannot infer d_sae from exp_factor without d_model in checkpoint."
            )
        cfg["d_sae"] = d_model * exp_factor
    return cfg


def cfg_from_header(header: dict[str, tp.Any]) -> modeling.SparseAutoencoderConfig:
    """Reconstruct a SparseAutoencoderConfig from any historical header schema
    (reference load, modeling.py:578-654)."""
    if "schema" not in header:
        # Pre-schema format: raw config params with d_vit naming, ReLU implied.
        header = dict(header)
        for keyword in ("sparsity_coeff", "ghost_grads", "l1_coeff", "use_ghost_grads", "seed"):
            header.pop(keyword, None)
        header["d_model"] = header.pop("d_vit")
        kwargs = _normalize_cfg_kwargs(header)
        return modeling.SparseAutoencoderConfig(**kwargs, activation=modeling.Relu())

    schema = header["schema"]
    if schema == 1:
        # Two incompatible formats shipped under schema 1 (reference modeling.py:601-634).
        cls_name = header.get("cls", "SparseAutoencoderConfig")
        cfg_dict = dict(header["cfg"])
        if cls_name in ("Relu", "TopK", "BatchTopK"):
            # Format 1A: cls names the activation type; activation knobs live
            # inline in the cfg dict and must not reach SparseAutoencoderConfig.
            act_cls = _ACTIVATION_CLASSES[cls_name]
            if cls_name in ("TopK", "BatchTopK"):
                activation = act_cls(top_k=cfg_dict.pop("top_k", 32))
            else:
                activation = act_cls()
            for knob in ("momentum", "sparsity_coeff"):
                cfg_dict.pop(knob, None)
            kwargs = _normalize_cfg_kwargs(cfg_dict)
            return modeling.SparseAutoencoderConfig(**kwargs, activation=activation)
        # Format 1B: activation is a payload dict.
        if "activation" in cfg_dict:
            cfg_dict["activation"] = deserialize_dataclass_payload(
                cfg_dict["activation"], allow_legacy_nested=True
            )
        kwargs = _normalize_cfg_kwargs(cfg_dict)
        return modeling.SparseAutoencoderConfig(**kwargs)
    if schema in (2, 3, 4, 5):
        cfg_dict = dict(header["cfg"])
        cfg_dict["activation"] = deserialize_dataclass_payload(
            cfg_dict["activation"], allow_legacy_nested=schema < 5
        )
        kwargs = _normalize_cfg_kwargs(cfg_dict)
        return modeling.SparseAutoencoderConfig(**kwargs)
    raise ValueError(f"Unknown schema version: {schema}")


# ---------------------------------------------------------------------------
# dump / load
# ---------------------------------------------------------------------------


def _state_dict_from_params(
    cfg: modeling.SparseAutoencoderConfig,
    params: modeling.Params,
    state: modeling.State | None,
) -> dict[str, torch.Tensor]:
    def f32(v) -> torch.Tensor:
        return torch.as_tensor(v).detach().to("cpu", torch.float32).clone()

    sd = {k: f32(params[k]) for k in ("W_dec", "b_dec", "W_enc", "b_enc")}
    if isinstance(cfg.activation, modeling.BatchTopK):
        sd["activation.threshold"] = f32(state["threshold"] if state is not None else 0.0)
    return sd


def dump(
    fpath: pathlib.Path | str,
    cfg: modeling.SparseAutoencoderConfig,
    params: modeling.Params,
    state: modeling.State | None = None,
):
    """Save an SAE checkpoint in the reference's schema-5 single-file format
    (reference modeling.py:549-574): JSON header line + torch.save(state_dict).
    """
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["activation"] = serialize_dataclass(cfg.activation)
    header = {
        "schema": SCHEMA_VERSION,
        "cfg": cfg_dict,
        "commit": helpers.current_git_commit() or "unknown",
        "lib": _lib_version(),
    }

    fpath = pathlib.Path(fpath)
    fpath.parent.mkdir(exist_ok=True, parents=True)
    sd = _state_dict_from_params(cfg, params, state)
    with open(fpath, "wb") as fd:
        helpers.jdump(header, fd, append_newline=True)
        torch.save(sd, fd)


def load(
    fpath: pathlib.Path | str, device: torch.device | str = "cuda",
) -> tuple[modeling.SparseAutoencoderConfig, modeling.Params, modeling.State]:
    """Load an SAE checkpoint (any historical schema; reference modeling.py:578-658).

    Returns (cfg, params, state) as float32 tensors on `device` (the card
    unless the caller asks for the CPU).
    """
    with open(fpath, "rb") as fd:
        header = json.loads(fd.readline())
        buffer = io.BytesIO(fd.read())

    cfg = cfg_from_header(header)
    sd = torch.load(buffer, weights_only=True, map_location="cpu")

    params: modeling.Params = {
        k: sd[k].to(device=device, dtype=torch.float32) for k in ("W_dec", "b_dec", "W_enc", "b_enc")
    }
    # Guard the header<->tensor contract so a corrupted or mismatched
    # checkpoint fails with named dimensions.
    guards.check("W_dec", params["W_dec"], ndim=2, axis0=cfg.d_sae,
                 last_dim=cfg.d_model, what=f"checkpoint header {fpath}")
    guards.check("W_enc", params["W_enc"], ndim=2, axis0=cfg.d_model,
                 last_dim=cfg.d_sae, what=f"checkpoint header {fpath}")
    guards.check("b_enc", params["b_enc"], ndim=1, axis0=cfg.d_sae,
                 what=f"checkpoint header {fpath}")
    guards.check("b_dec", params["b_dec"], ndim=1, axis0=cfg.d_model,
                 what=f"checkpoint header {fpath}")
    state = modeling.init_state(cfg, device)
    if "activation.threshold" in sd:
        state = {
            **state,
            "threshold": sd["activation.threshold"].to(device=device, dtype=torch.float32).reshape(()),
        }
    return cfg, params, state


def _lib_version() -> str:
    from .. import __version__

    return __version__
