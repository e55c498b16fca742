"""Deterministic fault injection + recovery (see plan.py for the taxonomy);
twin of repro/fault/.

Kept import-light: `recovery` pulls the trainers, so import it as a
submodule (`from repro_torch.fault import recovery`) only where needed.
"""

from repro_torch.fault.inject import (
    FaultEscalation,
    FaultInjector,
    InjectedFault,
    TransientFault,
    TransientFetchFault,
    TransientSampleFault,
    WorkerCrash,
    clear_fetch_hook,
    corrupt_latest_checkpoint,
    install_fetch_hook,
    retry_call,
)
from repro_torch.fault.plan import (
    FAULT_KINDS,
    FaultEvent,
    FaultPlan,
    FaultSpecError,
    parse_fault_spec,
)

__all__ = [
    "FAULT_KINDS",
    "FaultEscalation",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "FaultSpecError",
    "InjectedFault",
    "TransientFault",
    "TransientFetchFault",
    "TransientSampleFault",
    "WorkerCrash",
    "clear_fetch_hook",
    "corrupt_latest_checkpoint",
    "install_fetch_hook",
    "parse_fault_spec",
    "retry_call",
]
