"""Failure injection for fault-tolerance tests.

At pod scale the failure modes are: host crash (process dies), device error
(XLA raises), and network partition (collective hangs -> job restart by the
cluster manager). All three surface to the training loop as "the step raised
and in-memory state is gone"; the recovery contract is identical — restart
from the last committed checkpoint and replay the deterministic data stream.
``FailureInjector`` simulates that contract in-process.
"""
from __future__ import annotations

import dataclasses


class InjectedFailure(RuntimeError):
    """Simulated host/device failure."""


@dataclasses.dataclass
class FailureInjector:
    """Raises InjectedFailure at the given steps (each fires once)."""

    fail_at_steps: tuple[int, ...] = ()

    def __post_init__(self):
        self._pending = set(self.fail_at_steps)

    def check(self, step: int) -> None:
        if step in self._pending:
            self._pending.discard(step)
            raise InjectedFailure(f"injected failure at step {step}")
