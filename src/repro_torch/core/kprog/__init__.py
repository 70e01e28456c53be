"""Kernel-program IR: declarative warp-specialization layer + registry.

``repro_torch.core.kprog.ir`` defines the IR (roles, rings, named tokens) and the
``KernelSpec.build()`` lowering to engine traces; ``registry`` maps kernel
names to registered specs (``fa3``, ``fa3_cooperative``, ``fa2``,
``splitkv_decode``) and statically verifies each one at resolve time;
``verify`` is the legality oracle itself (deadlock freedom, protocol
discipline, hazards — see docs/verification.md).  See docs/kernels.md.
"""
from repro_torch.core.kprog.ir import CTABuilder, KernelSpec, Ring, Role, WGProgram
from repro_torch.core.kprog.registry import available, get, register
from repro_torch.core.kprog.verify import (Finding, KernelVerificationError,
                                     VerifyReport, verify_cta, verify_ctas,
                                     verify_spec)

__all__ = ["CTABuilder", "KernelSpec", "Ring", "Role", "WGProgram",
           "available", "get", "register",
           "Finding", "KernelVerificationError", "VerifyReport",
           "verify_cta", "verify_ctas", "verify_spec"]
