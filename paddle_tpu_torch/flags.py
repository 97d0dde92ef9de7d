"""Runtime flag registry (port of ``paddle_tpu/flags.py``).

Only the flags this port reads are defined. Each is overridable from the
environment (``FLAGS_<name>=...``) at import and mutable at runtime with
:func:`set_flags`. There is deliberately no flag that turns the CUDA
kernels off: on a CUDA tensor a kernel wrapper launches its kernel or
raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "flag", "set_flags"]

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}

_FLAGS: Dict[str, Any] = {}
_DEFAULTS: Dict[str, Any] = {}


def _parse(raw: str, default: Any) -> Any:
    if isinstance(default, bool):
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"cannot parse boolean flag value {raw!r}")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def define_flag(name: str, default: Any) -> None:
    if name in _FLAGS:
        raise ValueError(f"flag {name!r} already defined")
    env = os.environ.get(f"FLAGS_{name}")
    _DEFAULTS[name] = default
    _FLAGS[name] = default if env is None else _parse(env, default)


def flag(name: str) -> Any:
    try:
        return _FLAGS[name]
    except KeyError:
        raise KeyError(f"unknown flag {name!r}") from None


def set_flags(values: Dict[str, Any]) -> None:
    for name, value in values.items():
        default = _DEFAULTS.get(name, KeyError)
        if default is KeyError:
            raise KeyError(f"unknown flag {name!r}")
        if (isinstance(default, (bool, int, float, str))
                and not isinstance(value, type(default))):
            value = _parse(str(value), default)
        _FLAGS[name] = value


# serving options the engine reads; the port raises NotImplementedError
# for every non-default value until its ROADMAP item lands
define_flag("serve_spec_tokens", 0)
define_flag("serve_prefix_cache", False)
define_flag("serve_kv_quant", "off")
define_flag("serve_kv_host_tier", False)
define_flag("serve_weight_quant", False)
