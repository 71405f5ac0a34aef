"""Parameter surface of the serving path: defaults, aliases, coercion.

The JAX package's config.py holds every training and serving key; the
port carries only the keys its predict/serve path reads, with the same
names, aliases and defaults, so a conf file written for the JAX CLI runs
here unchanged.  Any other key is accepted and ignored with one warning
per key.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Mapping, Optional

from .utils import coerce_bool as _coerce_bool
from .utils import log

# alias -> canonical name (the JAX config's table, cut to these keys)
PARAM_ALIASES: Dict[str, str] = {
    "config": "config_file",
    "train_data": "data",
    "train": "data",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "predict_raw_score": "is_predict_raw_score",
    "raw_score": "is_predict_raw_score",
    "header": "has_header",
    "verbosity": "verbose",
}

_DEFAULTS: Dict[str, Any] = {
    "task": "train",
    "data": "",
    "input_model": "",
    "output_result": "LightGBM_predict_result.txt",
    "verbose": 1,
    "has_header": False,
    "is_predict_raw_score": False,
    "num_iteration_predict": -1,
    # serving (the JAX config's serve_* defaults)
    "serve_host": "127.0.0.1",
    "serve_port": 8080,
    "serve_max_batch": 8192,
    "serve_max_delay_ms": 5.0,
    "predict_buckets": [],
    "serve_walk": "auto",
    "serve_quantize_leaves": False,
    "serve_max_body_bytes": 33554432,
    "serve_nonfinite_policy": "reject",
    # the port's own: where the forest runs ("cuda" or "cpu")
    "device": "cuda",
}

_BOOL_KEYS = {k for k, v in _DEFAULTS.items() if isinstance(v, bool)}
_INT_KEYS = {k for k, v in _DEFAULTS.items()
             if isinstance(v, int) and not isinstance(v, bool)}
_FLOAT_KEYS = {k for k, v in _DEFAULTS.items() if isinstance(v, float)}
_LIST_KEYS = {"predict_buckets"}


def apply_aliases(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Canonical keys win over aliases (reference config.h:405-415)."""
    out: Dict[str, Any] = {}
    aliased: Dict[str, Any] = {}
    for key, value in params.items():
        key = key.strip()
        if key in PARAM_ALIASES:
            aliased[PARAM_ALIASES[key]] = value
        else:
            out[key] = value
    for key, value in aliased.items():
        out.setdefault(key, value)
    return out


def _coerce_list(value: Any, elem=str) -> List[Any]:
    if isinstance(value, (list, tuple)):
        return [elem(v) for v in value]
    s = str(value).strip()
    if not s:
        return []
    return [elem(v) for v in s.replace(",", " ").split()]


class Config:
    """Typed view over a params dict after alias resolution
    (``cfg.serve_port``)."""

    def __init__(self, params: Optional[Mapping[str, Any]] = None):
        params = apply_aliases(dict(params or {}))
        self.raw: Dict[str, Any] = params
        self._values: Dict[str, Any] = copy.deepcopy(_DEFAULTS)
        for key, value in params.items():
            if key not in self._values:
                if key != "config_file":
                    log.warn_once(f"config:{key}",
                                  "parameter %r is not read by the torch "
                                  "port; ignored", key)
                continue
            self._values[key] = self._coerce(key, value)
        self._check()

    @staticmethod
    def _coerce(key: str, value: Any) -> Any:
        if key in _LIST_KEYS:
            return _coerce_list(value, int)
        if key in _BOOL_KEYS:
            return _coerce_bool(value)
        if key in _INT_KEYS:
            return int(float(value))
        if key in _FLOAT_KEYS:
            return float(value)
        return str(value).strip() if isinstance(value, str) else value

    def _check(self) -> None:
        v = self._values
        if v["serve_max_batch"] <= 0:
            raise ValueError("serve_max_batch must be > 0")
        if v["serve_max_delay_ms"] < 0:
            raise ValueError("serve_max_delay_ms must be >= 0")
        if v["serve_max_body_bytes"] < 0:
            raise ValueError("serve_max_body_bytes must be >= 0 "
                             "(0 = no request body cap)")
        if v["serve_nonfinite_policy"] not in ("reject", "propagate"):
            raise ValueError(
                f"Unknown serve_nonfinite_policy "
                f"{v['serve_nonfinite_policy']} "
                "(expected reject or propagate)")
        if v["serve_walk"] not in ("auto", "fused", "gather"):
            raise ValueError(
                f"Unknown serve_walk {v['serve_walk']} "
                "(expected auto, fused or gather)")
        if any(b <= 0 for b in v["predict_buckets"]):
            raise ValueError("predict_buckets must be positive sizes")

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __getitem__(self, name: str) -> Any:
        return self._values[name]

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)


def parse_config_file(path: str) -> Dict[str, str]:
    """``key = value`` conf file with ``#`` comments (reference
    application.cpp:46-104)."""
    params: Dict[str, str] = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            params[key.strip()] = value.strip()
    return params


def parse_cli_args(argv: List[str]) -> Dict[str, str]:
    """``k=v`` CLI tokens; a ``config=`` file is read first and the
    command line overrides it (reference application.cpp:46-76)."""
    params: Dict[str, str] = {}
    for token in argv:
        if "=" not in token:
            if token.startswith("--"):
                log.warning("ignoring CLI flag %r: flags must use the "
                            "--key=value form", token)
            continue
        key, value = token.split("=", 1)
        key = key.strip()
        if key.startswith("--"):
            key = key[2:].replace("-", "_")
        params[key] = value.strip()
    params = apply_aliases(params)
    config_path = params.pop("config_file", None)
    if config_path:
        file_params = apply_aliases(parse_config_file(config_path))
        file_params.update(params)
        params = file_params
    return params
