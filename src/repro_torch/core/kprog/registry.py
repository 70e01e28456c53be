"""Kernel registry: name -> KernelSpec.

Built-in specs (fa3, fa3_cooperative, fa2, splitkv_decode) self-register on
first lookup; external code can register additional specs with
:func:`register` before driving them through ``simulate_fa3(kernel=...)``.

Resolution doubles as the legality gate: :func:`get` statically verifies
each spec once (lowering its probe workload through
:mod:`repro_torch.core.kprog.verify`) and raises
:class:`~repro_torch.core.kprog.verify.KernelVerificationError` on deadlocks or
protocol violations, so an illegal spec fails in microseconds at resolve
time instead of timing out a simulation.  Opt out per call
(``get(k, verify=False)``) or process-wide (``REPRO_KPROG_VERIFY=0``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

from repro_torch.core.kprog.ir import KernelSpec

_REGISTRY: Dict[str, KernelSpec] = {}
_BUILTINS_LOADED = False
_VERIFY_ENV = "REPRO_KPROG_VERIFY"


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"kernel {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_builtins() -> None:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    # imports self-register; deferred so repro_torch.core.analytical (imported by
    # the spec modules) never cycles at module-import time.  The flag flips
    # only on success so a failed import surfaces again on the next lookup
    # instead of leaving a silently empty registry.
    from repro_torch.core.kprog import decode, fa2, fa3  # noqa: F401
    _BUILTINS_LOADED = True


def _verify_once(spec: KernelSpec) -> KernelSpec:
    """Run resolve-time static verification, cached per spec instance.
    Errors raise; warnings are tolerated (the report is kept on the spec
    as ``_kprog_verify_report`` for callers that want to inspect it)."""
    if getattr(spec, "_kprog_verified", False):
        return spec
    from repro_torch.core.kprog.verify import KernelVerificationError, verify_spec
    report = verify_spec(spec)
    spec._kprog_verify_report = report
    if not report.ok:
        raise KernelVerificationError(report)
    spec._kprog_verified = True
    return spec


def get(kernel: Union[str, KernelSpec], *,
        verify: Optional[bool] = None) -> KernelSpec:
    """Resolve a kernel name (or pass a spec through), statically verifying
    the spec once at first resolution.

    ``verify=None`` follows the ``REPRO_KPROG_VERIFY`` env switch (default
    on); ``verify=False`` skips the check for this call; ``verify=True``
    forces it regardless of the environment.
    """
    if verify is None:
        verify = os.environ.get(_VERIFY_ENV, "1") not in ("0", "off", "no")
    if isinstance(kernel, KernelSpec):
        return _verify_once(kernel) if verify else kernel
    _ensure_builtins()
    try:
        spec = _REGISTRY[kernel]
    except KeyError:
        raise KeyError(f"unknown kernel {kernel!r}; "
                       f"available: {sorted(_REGISTRY)}") from None
    return _verify_once(spec) if verify else spec


def available() -> List[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)
