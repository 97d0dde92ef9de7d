"""The ops plane's fleet seam (port of ``paddle_tpu/observability/ops.py``:
``post_host_health`` :129-163).

The per-process health reporter (``health_payload``, ``maybe_report``, the
serving-source slot it reads, the stall and numerics notices, bundle
upload) belongs to the training ops plane and waits for ROADMAP.md A.12;
a fleet host posts its serving block through :func:`post_host_health`.
"""

from __future__ import annotations

import json
import logging
import urllib.request as _urlreq
from typing import Any, Dict, Optional

__all__ = ["post_host_health"]

_log = logging.getLogger("paddle_tpu_torch.observability.ops")

def post_host_health(master_address: str, name: str,
                     serving: Optional[Dict] = None,
                     step: Optional[int] = None,
                     timeout: float = 3.0) -> Optional[Dict]:
    """POST one /health report for the named host to the master. Never
    raises; returns the master's answer or None. Honors
    ``fault_router_partition``: a dropped host's reports are lost, as on a
    cut network path."""
    from paddle_tpu_torch.testing import fault_injection
    if fault_injection.router_partitioned(name):
        return None
    payload: Dict[str, Any] = {"name": name}
    if step is not None:
        payload["step"] = int(step)
    if serving:
        payload["serving"] = serving
    try:
        req = _urlreq.Request(
            master_address.rstrip("/") + "/health",
            data=json.dumps(payload, default=str).encode(),
            headers={"Content-Type": "application/json"})
        with _urlreq.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except Exception as e:                          # noqa: BLE001
        _log.debug("fleet health POST for %s failed: %r", name, e)
        return None
