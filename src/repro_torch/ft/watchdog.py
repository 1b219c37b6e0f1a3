"""Straggler/hang watchdog for the training loop (a copy of
``repro.ft.watchdog``: threading and time only).

Every step arms a deadline; if the step (or the data queue) exceeds it, the
incident is logged and counted. Policies:
  * "log"    — record and continue (default; stragglers are transient),
  * "raise"  — abort so the job-level restarter (launch/train.py --resume)
               relaunches from the last checkpoint.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class Incident:
    step: int
    elapsed_s: float
    kind: str


class StepWatchdog:
    def __init__(self, deadline_s: float = 60.0, policy: str = "log",
                 on_incident: Optional[Callable[[Incident], None]] = None):
        self.deadline_s = deadline_s
        self.policy = policy
        self.on_incident = on_incident
        self.incidents: List[Incident] = []
        self._timer: Optional[threading.Timer] = None
        self._armed_step = -1
        self._t0 = 0.0
        self._fired = threading.Event()

    def arm(self, step: int):
        self.disarm()
        self._armed_step = step
        self._t0 = time.monotonic()
        self._fired.clear()
        self._timer = threading.Timer(self.deadline_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def _fire(self):
        inc = Incident(self._armed_step,
                       time.monotonic() - self._t0, "step_deadline")
        self.incidents.append(inc)
        self._fired.set()
        if self.on_incident:
            self.on_incident(inc)

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def check(self):
        """Call after each step: enforce the policy for fired deadlines."""
        if self._fired.is_set() and self.policy == "raise":
            raise TimeoutError(
                f"step {self._armed_step} exceeded "
                f"{self.deadline_s}s deadline (straggler/hang)")

    def close(self):
        self.disarm()
