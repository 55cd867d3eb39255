"""Wire faults: the data-plane adversary of the P2P streams — the port's
copy of ``WireFault``, ``WireFaultPlan``, ``wire_fault_plan`` and
``set_wire_fault_plan`` from ``dsml_tpu/runtime/chaos.py``.

The device server's push path (``comm/device_server.py``) asks the active
plan about every outbound stream; a fault corrupts, delays, truncates
(``drop``) or severs (``partition``) that push. ``DSML_CHAOS_WIRE`` sets
the plan for a process (``"drop@1"``, ``"corrupt@*"``, grammar at
:meth:`WireFaultPlan.parse`); :func:`set_wire_fault_plan` installs one in
process. The kill/restore schedules of the training controller and the
serving fleet come with the elasticity slice.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

from dsml_tpu_torch.utils.logging import get_logger

__all__ = ["WireFault", "WireFaultPlan", "set_wire_fault_plan", "wire_fault_plan"]

log = get_logger("chaos")


@dataclasses.dataclass
class WireFault:
    """One data-plane fault, applied by ``device_server._push_stream``:

    - ``drop`` — truncate the StreamSend mid-stream (the receiver keeps a
      partial prefix, the sender's call errors);
    - ``corrupt`` — flip one byte mid-payload (exactly what the migration
      path's per-chunk CRC32C must catch);
    - ``delay`` — sleep ``delay_s`` before pushing (timeout exercise);
    - ``partition`` — sever the link: the push fails before any byte moves.

    ``nth`` selects the 1-based send ordinal the fault fires on (None =
    every matching send); ``src``/``dst`` restrict to one link."""

    action: str
    nth: int | None = None
    src: int | None = None
    dst: int | None = None
    delay_s: float = 0.1

    _ACTIONS = ("drop", "corrupt", "delay", "partition")

    def __post_init__(self):
        if self.action not in self._ACTIONS:
            raise ValueError(f"unknown wire-fault action {self.action!r}")

    def matches(self, ordinal: int, src, dst) -> bool:
        if self.nth is not None and ordinal != self.nth:
            return False
        if self.src is not None and src != self.src:
            return False
        if self.dst is not None and dst != self.dst:
            return False
        return True

    def apply_payload(self, payload: bytes) -> bytes:
        if self.action == "corrupt":
            mutated = bytearray(payload)
            if mutated:
                mutated[len(mutated) // 2] ^= 0xFF
            return bytes(mutated)
        if self.action == "delay":
            time.sleep(self.delay_s)
        return payload


class WireFaultPlan:
    """A per-link wire-fault schedule, keyed on the process-wide send
    ordinal. Spec grammar (``DSML_CHAOS_WIRE``): semicolon-separated
    ``action@sel[,src=N][,dst=N][,s=SECONDS]`` where ``sel`` is a 1-based
    send ordinal or ``*`` (every send) — e.g.
    ``"drop@1;corrupt@3"`` or ``"delay@*,dst=1,s=0.05"``."""

    def __init__(self, faults):
        self.faults = list(faults)
        self._sends = 0
        self._lock = threading.Lock()
        self.fired: list[dict] = []

    @classmethod
    def parse(cls, spec: str) -> "WireFaultPlan":
        faults = []
        for token in spec.split(";"):
            token = token.strip().lower()
            if not token:
                continue
            head, _, rest = token.partition(",")
            if "@" not in head:
                raise ValueError(f"wire-fault token {token!r}: expected action@sel")
            action, sel = head.split("@", 1)
            fault = {"action": action.strip(),
                     "nth": None if sel.strip() == "*" else int(sel)}
            for kv in rest.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                if k == "src":
                    fault["src"] = int(v)
                elif k == "dst":
                    fault["dst"] = int(v)
                elif k == "s":
                    fault["delay_s"] = float(v)
                else:
                    raise ValueError(f"wire-fault token {token!r}: unknown key {k!r}")
            faults.append(WireFault(**fault))
        return cls(faults)

    def on_send(self, src, dst) -> WireFault | None:
        """Called by the device server once per outbound stream push;
        returns the fault to apply (if any) and records the firing."""
        with self._lock:
            self._sends += 1
            ordinal = self._sends
            for fault in self.faults:
                if fault.matches(ordinal, src, dst):
                    self.fired.append(
                        {"action": fault.action, "ordinal": ordinal,
                         "src": src, "dst": dst}
                    )
                    log.warning("wire fault: %s on send #%d (%s -> %s)",
                                fault.action, ordinal, src, dst)
                    from dsml_tpu_torch.obs import get_registry

                    reg = get_registry()
                    if reg.enabled:
                        reg.counter(
                            "chaos_wire_faults_total",
                            "injected data-plane faults", labels=("action",),
                        ).inc(action=fault.action)
                    return fault
        return None


_WIRE_UNSET = object()
_WIRE_PLAN = _WIRE_UNSET


def wire_fault_plan() -> WireFaultPlan | None:
    """The process's active wire-fault plan: whatever
    :func:`set_wire_fault_plan` installed, else ``DSML_CHAOS_WIRE`` parsed
    once (None when unset/empty — the zero-cost production answer)."""
    global _WIRE_PLAN
    if _WIRE_PLAN is _WIRE_UNSET:
        spec = os.environ.get("DSML_CHAOS_WIRE", "").strip()
        _WIRE_PLAN = WireFaultPlan.parse(spec) if spec else None
    return _WIRE_PLAN


def set_wire_fault_plan(plan: WireFaultPlan | None) -> None:
    """Install (or, with None, clear) the active plan — the in-process
    test hook; subprocesses use the env knob."""
    global _WIRE_PLAN
    _WIRE_PLAN = plan
