"""Fault injection: prove the chaos-survival guarantee, don't assert it —
the counterpart of ``dsml_tpu/runtime/chaos.py``.

``runtime.controller`` claims it rides preemptions end-to-end. This module
is the adversary that makes the claim testable: scripted and seeded-random
kill/restore schedules driven against the training controller (slot loss:
the slot's worker process is terminated for real, ``parallel.world``) and
the serving ``DecodeFleet`` (replica loss), with the invariants checked
afterwards:

- **zero lost steps** — the final lineage contains every step exactly
  once (the step counter reaches the target and nothing was skipped);
- **bit-identity** (``growback="replay"``) — final params bit-identical
  to an uninterrupted run at the same step count on the same full world;
- **goodput floor** — productive ÷ wall stays above a documented floor
  for the harness (the FLOOR EXISTING is the guarantee; world joins and
  state moves dominate a tiny model's wall);
- **zero token loss** (serving) — every request killed mid-decode re-runs
  on a survivor and its final tokens equal the single-batcher reference
  (greedy decode is a pure function of the prompt).

Faults are injected through the doors the controller watches: the fleet
view (``VirtualFleet.kill`` — the health-probe verdict, and the worker
killed), the signal queue (``controller.inject(DeviceLost(...))``), and a
rank killing itself inside a step (``ElasticController.kill_mid_step``).
The data-plane adversary of the P2P streams (``WireFault``) rides the
device server's push path.

Env knob ``DSML_CHAOS`` selects a schedule for the smoke entry point
(``python -m dsml_tpu_torch.runtime.chaos``; add ``--device cpu`` here):
unset/``0`` → off, ``1`` → the default scripted schedule, ``seed:<n>`` →
seeded-random. ``DSML_CHAOS_WIRE`` sets the wire-fault plan of a process
(``"drop@1"``, ``"corrupt@*"``, grammar at :meth:`WireFaultPlan.parse`).
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time

import numpy as np

from dsml_tpu_torch.utils.logging import get_logger

__all__ = [
    "ChaosEvent",
    "ChaosSchedule",
    "VirtualFleet",
    "WireFault",
    "WireFaultPlan",
    "wire_fault_plan",
    "set_wire_fault_plan",
    "config_from_env",
    "run_chaos_training",
    "run_chaos_serving",
    "run_chaos_serving_fleet",
    "run_smoke",
    "run_migration_smoke",
    "verify",
    "verify_migration",
]

log = get_logger("chaos")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One fault: at ``step`` (training) / ``tick`` (serving), ``kill`` the
    targets or ``restore`` them (empty targets = everything dead)."""

    step: int
    action: str  # "kill" | "restore"
    targets: tuple = ()
    inject: bool = False  # also push a DeviceLost signal (vs probe-only)

    def __post_init__(self):
        if self.action not in ("kill", "restore"):
            raise ValueError(f"unknown chaos action {self.action!r}")


class ChaosSchedule:
    """An ordered list of :class:`ChaosEvent`; scripted or seeded-random."""

    def __init__(self, events):
        self.events = tuple(sorted(events, key=lambda e: e.step))

    @classmethod
    def scripted_default(cls, n_devices: int = 8) -> "ChaosSchedule":
        """The CI smoke schedule: 3 kills at distinct steps (one injected,
        two probe-detected), then a full restore — the ≥3-kills/1-restore
        shape the acceptance criterion names."""
        return cls([
            ChaosEvent(6, "kill", (n_devices - 1,), inject=True),
            ChaosEvent(10, "kill", (2,)),
            ChaosEvent(13, "kill", (0,)),
            ChaosEvent(17, "restore", ()),
        ])

    @classmethod
    def seeded(cls, seed: int, n_steps: int = 24, n_devices: int = 8,
               n_kills: int = 3) -> "ChaosSchedule":
        """Seeded-random schedule: ``n_kills`` distinct devices die at
        distinct steps in the first two-thirds of the run (always leaving
        at least one survivor), then everything restores. ``random.Random(
        seed)`` draws exactly as the JAX package's does: the same seed gives
        the same events."""
        rng = random.Random(seed)
        n_kills = min(n_kills, n_devices - 1)
        lo, hi = 2, max(2 * n_steps // 3, 3)
        steps = sorted(rng.sample(range(lo, hi + 1), min(n_kills, hi - lo + 1)))
        targets = rng.sample(range(n_devices), len(steps))
        events = [
            ChaosEvent(s, "kill", (t,), inject=rng.random() < 0.5)
            for s, t in zip(steps, targets)
        ]
        restore_at = min(steps[-1] + rng.randint(2, 5), n_steps - 4)
        events.append(ChaosEvent(max(restore_at, steps[-1] + 1), "restore", ()))
        return cls(events)

    def at(self, step: int) -> list[ChaosEvent]:
        return [e for e in self.events if e.step == step]

    def kills(self) -> int:
        return sum(1 for e in self.events if e.action == "kill")


def config_from_env(spec: str | None = None) -> ChaosSchedule | None:
    """``DSML_CHAOS``: unset/``0`` → None; ``1`` → the scripted default;
    ``seed:<n>`` → :meth:`ChaosSchedule.seeded`."""
    if spec is None:
        spec = os.environ.get("DSML_CHAOS", "")
    spec = spec.strip().lower()
    if spec in ("", "0", "false", "off"):
        return None
    if spec in ("1", "true", "on", "scripted"):
        return ChaosSchedule.scripted_default()
    if spec.startswith("seed:"):
        try:
            return ChaosSchedule.seeded(int(spec[5:]))
        except ValueError as e:
            raise ValueError(f"DSML_CHAOS={spec!r}: bad seed") from e
    raise ValueError(
        f"DSML_CHAOS={spec!r} is not one of 0/1/scripted/seed:<n>"
    )


class VirtualFleet:
    """A fleet view the harness can lie through: ``kill`` hides slots from
    ``available()`` (what a coordinator health probe would report) and,
    with a ``pool`` (``parallel.world.WorkerPool``), terminates their worker
    processes for real, after the world's in-flight checkpoint commits
    landed; ``restore`` brings them back (capacity returning: new worker
    processes). Indices are into the original slot list. A
    slot whose worker died by other means (a rank that died inside a
    step) is not available either, until restored."""

    def __init__(self, devices, pool=None):
        self._devices = list(devices)
        self._dead: set[int] = set()
        self.pool = pool

    def available(self) -> list:
        return [d for i, d in enumerate(self._devices) if i not in self._dead
                and (self.pool is None or self.pool.is_alive(d))]

    def kill(self, *indices: int) -> list:
        dead = []
        for i in indices:
            if i not in self._dead and 0 <= i < len(self._devices):
                self._dead.add(i)
                dead.append(self._devices[i])
        if len(self._dead) >= len(self._devices):
            raise RuntimeError("chaos killed the whole fleet")
        if self.pool is not None and dead:
            # a kill between steps lands after the last save committed (a
            # save is one unit in the JAX package's single process)
            self.pool.kill(*dead, settle=True)
        return dead

    def restore(self, *indices: int) -> list:
        if self.pool is not None and not indices:
            # a worker that died inside a step comes back too
            self._dead |= {i for i, d in enumerate(self._devices) if not self.pool.is_alive(d)}
        back = sorted(self._dead) if not indices else list(indices)
        restored = [self._devices[i] for i in back
                    if i in self._dead or (self.pool is not None
                                           and not self.pool.is_alive(self._devices[i]))]
        self._dead -= set(back)
        if self.pool is not None and restored:
            self.pool.restore(*restored)
        return restored

    @property
    def n_dead(self) -> int:
        return len(self._dead)


# ---------------------------------------------------------------------------
# wire faults: the DATA-PLANE adversary (P2P streams)
# ---------------------------------------------------------------------------


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


def run_chaos_training(controller, schedule: ChaosSchedule, n_steps: int) -> dict:
    """Drive ``controller.run(n_steps)`` with ``schedule`` applied through
    the controller's fleet (which must be a :class:`VirtualFleet`).
    Returns the controller report with the schedule appended."""
    from dsml_tpu_torch.runtime.controller import DeviceLost

    fleet = controller.fleet
    fired: set = set()

    def on_step(step: int) -> None:
        for ev in schedule.at(step):
            if id(ev) in fired:
                continue
            fired.add(id(ev))
            if ev.action == "kill":
                dead = fleet.kill(*ev.targets)
                log.warning("chaos: step %d kill %s", step, list(ev.targets))
                if ev.inject and dead:
                    controller.inject(DeviceLost(dead, "chaos kill"))
            else:
                restored = fleet.restore(*ev.targets)
                log.warning("chaos: step %d restore %d device(s)", step, len(restored))

    report = controller.run(n_steps, on_step=on_step)
    report["schedule"] = [dataclasses.asdict(e) for e in schedule.events]
    return report


def run_chaos_serving(fleet, prompts, max_new: int, kill_ticks: dict,
                      max_ticks: int = 100_000) -> dict:
    """Drive a ``DecodeFleet`` to drain ``prompts`` while killing replicas
    at the scheduled ticks (``{tick: replica_id or None=newest}``).
    Returns ``{"results": {frid: tokens}, "ticks": n}``."""
    frids = [fleet.submit(p, max_new) for p in prompts]
    tick = 0
    while fleet.outstanding:
        if tick in kill_ticks and fleet.n_replicas:
            fleet.kill_replica(kill_ticks[tick])
        fleet.tick()
        tick += 1
        if tick > max_ticks:
            raise RuntimeError(f"serving chaos did not drain in {max_ticks}")
    results = fleet.run(max_ticks=1)  # drains the harvested results
    return {"results": {f: results.get(f, []) for f in frids}, "ticks": tick}


def run_chaos_serving_fleet(router, prompts, max_new, kill_ticks,
                            max_ticks: int = 100_000) -> dict:
    """The disaggregated-fleet variant of :func:`run_chaos_serving`: drive
    a ``serving.Router`` to drain ``prompts`` while killing WORKERS at the
    scheduled ticks — ``{tick: ("prefill"|"decode", idx or None=last)}``.
    A prefill worker killed mid-handoff loses its partial chunk state; the
    router re-prefills on a survivor. Returns results plus the requeue
    counts the verdict needs to prove the kill interrupted work in flight,
    and the request-tracing verdicts: a killed request's re-run must retire
    under the SAME trace_id with its retry recorded, and its SLO burn must
    count the FULL user-visible latency (original submit → final retire).
    ``max_new`` is every request's budget, or a list of one a prompt;
    ``kill_ticks`` anything with ``get(tick)`` (a dict, or a probe that
    picks the tick from the fleet's state)."""
    budgets = max_new if isinstance(max_new, (list, tuple)) else [max_new] * len(prompts)
    frids = [router.submit(p, n) for p, n in zip(prompts, budgets)]
    minted = {f: (router.trace_of(f).trace_id if router.trace_of(f) else None) for f in frids}
    tick = 0
    while router.outstanding:
        kill = kill_ticks.get(tick)
        if kill is not None:
            kind, idx = kill
            if kind == "prefill":
                router.kill_prefill_worker(idx)
            elif kind == "decode":
                router.kill_decode_worker(idx)
            else:
                raise ValueError(f"unknown worker kind {kind!r}")
        router.tick()
        tick += 1
        if tick > max_ticks:
            raise RuntimeError(f"serving chaos did not drain in {max_ticks}")
    results = router.run(max_ticks=1)  # drains the harvested results
    requeue_t: dict = {}
    for f, t in router.requeue_log:
        requeue_t[f] = t  # last requeue wins (the run that finished)
    requeued = [f for f in requeue_t if f in set(frids)]
    records = router.request_records
    same_trace = all(records.get(f, {}).get("trace_id") == minted.get(f)
                     and minted.get(f) is not None for f in requeued)
    retry_recorded = all(records.get(f, {}).get("retries", 0) >= 1 for f in requeued)
    # full-latency burn: the recorded e2e must EXCEED the post-requeue leg
    burn_full = all(
        records.get(f, {}).get("e2e_s") is not None
        and records[f].get("finished_mono") is not None
        and records[f]["e2e_s"] > (records[f]["finished_mono"] - requeue_t[f]) - 1e-9
        for f in requeued)
    return {
        "results": {f: results.get(f, []) for f in frids},
        "ticks": tick,
        "requeued_prefill": router.requeued_prefill,
        "requeued_decode": router.requeued_decode,
        "requeued_requests": len(requeued),
        "trace_requeue_same": int(same_trace),
        "trace_retry_recorded": int(retry_recorded),
        "trace_burn_full_latency": int(burn_full),
    }


# ---------------------------------------------------------------------------
# smoke: the end-to-end guarantee as an executable check
# ---------------------------------------------------------------------------

# documented goodput floor for THIS harness (eight slots, tiny model): the
# world joins and state moves of the recoveries dominate the wall, so the
# floor is low — the guarantee is that a floor EXISTS and holds
SMOKE_GOODPUT_FLOOR = 0.02


def _leaves(tree) -> list:
    """The leaves of a nested dict / list tree, dict keys sorted (the JAX
    flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bit_identical(tree_a, tree_b) -> bool:
    """Host trees (numpy) equal bit for bit, leaf for leaf."""
    la, lb = _leaves(tree_a), _leaves(tree_b)
    return len(la) == len(lb) and all(
        np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(la, lb))


def default_planner_overrides(device: str, n_slots: int) -> dict | None:
    """Slots sharing one card plan with their share of its memory (the
    planner would read the whole card's); on the CPU, None (the planner's
    own answer)."""
    import torch

    if not str(device).startswith("cuda"):
        return None
    total = torch.cuda.get_device_properties(torch.device(device)).total_memory
    return {"hbm_bytes": float(total) / n_slots}


def run_smoke(n_steps: int = 24, seeds: tuple = (), checkpoint_every: int = 4,
              tmp_dir: str | None = None, schedule: "ChaosSchedule | None" = None,
              serving: bool = True, device: str = "cuda", n_slots: int = 8,
              threads: int | None = None,
              planner_overrides: dict | None = None) -> dict:
    """The acceptance run: the scripted schedule (≥3 kills, 1 restore) on
    ``n_slots`` slots of GPT-2-tiny (``device``: every slot on the card, or
    ``"cpu"``) with ``growback="replay"`` — final params must be
    bit-identical to an uninterrupted run at the same step count, zero
    steps lost, goodput above :data:`SMOKE_GOODPUT_FLOOR`. ``seeds`` adds
    seeded-random schedules for the recovery-time distribution. Returns a
    report dict; :func:`verify` lists the violated invariants."""
    import shutil
    import tempfile

    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu_torch.parallel.mesh import MeshSpec
    from dsml_tpu_torch.parallel.world import TrainRecipe, WorkerPool
    from dsml_tpu_torch.runtime.controller import ControllerConfig, ElasticController

    if n_steps < 20:
        raise ValueError(
            f"chaos smoke needs n_steps >= 20 (the scripted schedule kills through step 13, "
            f"restores at 17, and grows at the next checkpoint boundary), got {n_steps}")
    cfg = GPT2Config.tiny()
    recipe = TrainRecipe(cfg, lr=1e-2)
    global_batch = 8
    rng = np.random.default_rng(0)
    data = rng.integers(0, cfg.vocab_size,
                        (n_steps + 8, global_batch, cfg.max_seq)).astype(np.int32)

    def batch_provider(step: int):
        x = data[step - 1]
        return x, np.roll(x, -1, 1).astype(np.int32)

    spec = MeshSpec(dp=n_slots)
    base = tmp_dir or tempfile.mkdtemp(prefix="dsml_chaos_")
    created = tmp_dir is None
    report: dict = {"n_steps": n_steps}
    if planner_overrides is None:
        planner_overrides = default_planner_overrides(device, n_slots)
    pool = WorkerPool(n_slots, recipe, device=device, workdir=os.path.join(base, "pool"),
                      threads=threads)
    slots = list(range(n_slots))
    try:
        # the uninterrupted reference: the same world, same batches, no
        # controller, no checkpoints, no failures
        world = pool.form(slots, spec, seed=0)
        ref_loss = None
        for s in range(1, n_steps + 1):
            ref_loss = world.step(*batch_provider(s))
        ref_params = _host_params(world)
        world.leave()

        def one_run(schedule: ChaosSchedule, name: str) -> dict:
            fleet = VirtualFleet(slots, pool)
            ctl = ElasticController(
                pool, batch_provider, checkpoint_dir=os.path.join(base, name), fleet=fleet,
                slots=slots, spec=spec,
                config=ControllerConfig(checkpoint_every=checkpoint_every, growback="replay"),
                global_batch=global_batch, seed=0, planner_overrides=planner_overrides)
            with ctl:
                rep = run_chaos_training(ctl, schedule, n_steps)
                rep["bit_identical"] = _bit_identical(_host_params(ctl.world), ref_params)
            fleet.restore()
            rep["final_loss"] = ctl.losses.get(n_steps)
            rep["ref_loss"] = ref_loss
            rep["kills"] = schedule.kills()
            return rep

        report["scripted"] = one_run(schedule or ChaosSchedule.scripted_default(n_slots),
                                     "scripted")
        recov = [r["recovery_ms"] for r in report["scripted"]["recoveries"]]
        for seed in seeds:
            rep = one_run(ChaosSchedule.seeded(seed, n_steps, n_devices=n_slots), f"seed{seed}")
            report[f"seed{seed}"] = rep
            recov += [r["recovery_ms"] for r in rep["recoveries"]]
        if recov:
            report["recovery_p50_ms"] = round(float(np.percentile(recov, 50)), 3)
            report["recovery_p99_ms"] = round(float(np.percentile(recov, 99)), 3)
            report["recovery_samples"] = len(recov)
        report["goodput_floor"] = SMOKE_GOODPUT_FLOOR
        # staging audit: after every recovery the controllers (and their
        # checkpoint writers) are closed — bytes still claimed as staging
        # in this process are a leak
        from dsml_tpu_torch.obs.memory import get_memory_ledger

        led = get_memory_ledger()
        report["ledger_staging_bytes_final"] = (led.claimed_bytes("checkpoint_staging")
                                                + led.claimed_bytes("migration_staging"))
        if serving:
            model = GPT2(cfg, device=device).init(0)
            report["serving"] = _serving_smoke(model, cfg, rng)
            report["serving_fleet"] = _serving_fleet_smoke(model, cfg, rng)
            report["serving_paged"] = _paged_serving_smoke(model, cfg, rng)
    finally:
        pool.close()
        if created:
            shutil.rmtree(base, ignore_errors=True)
    return report


def _host_params(world) -> dict:
    """A world's parameters on the host (numpy, the JAX layout)."""
    host = world.state()
    try:
        return host.tree()["params"]
    finally:
        host.remove()


def _serving_smoke(model, cfg, rng) -> dict:
    """Replica-loss smoke: a 2-replica decode fleet loses a replica
    mid-drain; every request re-runs on a survivor and the final tokens
    must equal the single-batcher reference (greedy ⇒ pure function of
    the prompt)."""
    from dsml_tpu_torch.runtime.controller import DecodeFleet
    from dsml_tpu_torch.serving import ContinuousBatcher

    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(3, 9)).astype(np.int32)
               for _ in range(6)]
    max_new = 6
    ref = ContinuousBatcher(model, n_slots=2)
    ref_rids = [ref.submit(p, max_new) for p in prompts]
    ref_tokens = ref.run()

    fleet = DecodeFleet(lambda: ContinuousBatcher(model, n_slots=2, max_queue=8),
                        min_replicas=2, max_replicas=3, scale_up_queue_depth=2,
                        scale_down_idle_ticks=4)
    out = run_chaos_serving(fleet, prompts, max_new, kill_ticks={3: None})
    token_loss = sum(1 for frid, rrid in zip(sorted(out["results"]), ref_rids)
                     if out["results"][frid] != ref_tokens[rrid])
    return {"requests": len(prompts), "token_mismatches": token_loss, "ticks": out["ticks"],
            "scale_events": len(fleet.scale_events)}


def _serving_fleet_smoke(model, cfg, rng) -> dict:
    """Disaggregated-fleet loss smoke: a 2-prefill / 2-decode fleet loses a
    PREFILL worker mid-handoff and later a decode worker; every interrupted
    request re-prefills/re-decodes on survivors and the final tokens must
    equal the single-batcher reference — zero token loss."""
    from dsml_tpu_torch.serving import ContinuousBatcher, build_fleet

    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(8, 24)).astype(np.int32)
               for _ in range(6)]
    max_new = 6
    ref = ContinuousBatcher(model, n_slots=2)
    ref_rids = [ref.submit(p, max_new) for p in prompts]
    ref_tokens = ref.run()

    router = build_fleet(model, n_prefill=2, n_decode=2, prefill_chunk=8, n_slots=2,
                         max_queue=8)
    out = run_chaos_serving_fleet(router, prompts, max_new,
                                  kill_ticks={1: ("prefill", None), 6: ("decode", None)})
    token_loss = sum(1 for frid, rrid in zip(sorted(out["results"]), ref_rids)
                     if out["results"][frid] != ref_tokens[rrid])
    return {"requests": len(prompts), "token_mismatches": token_loss, "ticks": out["ticks"],
            **{k: out[k] for k in ("requeued_prefill", "requeued_decode", "requeued_requests",
                                   "trace_requeue_same", "trace_retry_recorded",
                                   "trace_burn_full_latency")}}


def _paged_serving_smoke(model, cfg, rng) -> dict:
    """Paged-KV fleet loss smoke: a paged 2-prefill/2-decode fleet with a
    LIVE CoW prefix loses a decode worker mid-flight. Invariants:
    re-prefilled requests produce tokens identical to a monolithic paged
    batcher, the CoW sharing was live when the kill landed, and EVERY
    worker's pool — the killed one's included — reclaims its request pages
    (only the prefix registry's pages stay held)."""
    from dsml_tpu_torch.serving import ContinuousBatcher, build_fleet

    page_size = 8
    prefix = rng.integers(1, cfg.vocab_size, 20).astype(np.int32)
    prompts = []
    for i in range(6):
        tail = rng.integers(1, cfg.vocab_size, int(rng.integers(4, 12))).astype(np.int32)
        prompts.append(np.concatenate([prefix, tail]) if i % 2 else
                       rng.integers(1, cfg.vocab_size, int(rng.integers(8, 24))).astype(np.int32))
    max_new = 6
    ref = ContinuousBatcher(model, n_slots=2, prefill_chunk=8, paged_kv="int4",
                            page_size=page_size, n_pages=80)
    ref.register_prefix(prefix)
    ref_rids = [ref.submit(p, max_new) for p in prompts]
    ref_tokens = ref.run()

    router = build_fleet(model, n_prefill=2, n_decode=2, prefill_chunk=8, paged_kv="int4",
                         page_size=page_size, n_slots=2, max_queue=8, n_pages=80)
    router.register_prefix(prefix)
    workers = list(router.decode_workers) + list(router.prefill_workers)
    baseline_used = [_used_pages(w) for w in workers]
    ledger_kv_baseline = _ledger_kv_occupied_bytes()
    frids = [router.submit(p, max_new) for p in prompts]
    tick = 0
    peak_shared = 0
    while router.outstanding:
        if tick == 6:
            router.kill_decode_worker()
        router.tick()
        peak_shared = max(peak_shared, max(dw.shared_pages for dw in router.decode_workers))
        tick += 1
        if tick > 100_000:
            raise RuntimeError("paged serving chaos did not drain")
    results = router.run(max_ticks=1)
    token_loss = sum(1 for frid, rrid in zip(sorted(frids), ref_rids)
                     if results.get(frid, []) != ref_tokens[rrid])
    leaked = sum(max(_used_pages(w) - b, 0) for w, b in zip(workers, baseline_used))
    ledger_kv_final = _ledger_kv_occupied_bytes()
    report = {
        "requests": len(prompts),
        "token_mismatches": token_loss,
        "ticks": tick,
        "requeued_decode": router.requeued_decode,
        "peak_shared_pages": peak_shared,
        "leaked_pages": leaked,
        "ledger_kv_baseline_bytes": ledger_kv_baseline,
        "ledger_kv_final_bytes": ledger_kv_final,
        "ledger_balanced": int(ledger_kv_final <= ledger_kv_baseline + 0.5),
    }
    report.update(_paged_eviction_leg(model, cfg, rng))
    return report


def _used_pages(worker) -> int:
    return worker.used_pages if hasattr(worker, "used_pages") else worker._pages.used_pages


def _ledger_kv_occupied_bytes() -> float:
    """Fleet-wide OCCUPIED paged-KV bytes (live + CoW-shared) summed over
    every pool the memory ledger's weakly-held sources still see (GC first,
    so a retired batcher cannot shift a baseline-vs-final comparison)."""
    import gc

    from dsml_tpu_torch.obs.memory import get_memory_ledger

    gc.collect()
    claims = get_memory_ledger().claimed().get("kv_pages", {})
    return float(claims.get("live", 0.0) + claims.get("shared", 0.0))


def _paged_eviction_leg(model, cfg, rng) -> dict:
    """The EVICTION leg (``preemption=True``): a pool far too small for the
    worst case forces mid-decode preemptions. Invariants: every PREEMPTED
    request re-emits tokens identical to the uncontended big-pool run and
    the drained pool is back to empty — zero page leaks."""
    from dsml_tpu_torch.serving import ContinuousBatcher

    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (17, 9, 13)]
    budgets = [12, 12, 10]
    ref = ContinuousBatcher(model, n_slots=3, prefill_chunk=8, paged_kv="int4", page_size=8,
                            n_pages=40)
    ref_rids = [ref.submit(p, n) for p, n in zip(prompts, budgets)]
    got = ref.run()
    ref_tokens = [got[r] for r in ref_rids]

    srv = ContinuousBatcher(model, n_slots=3, prefill_chunk=8, paged_kv="int4", page_size=8,
                            n_pages=8, preemption=True)
    ledger_baseline = _ledger_kv_occupied_bytes()
    preempted_rids: set = set()
    evict = srv._evict_slot

    def spy(slot):
        preempted_rids.add(int(srv._slot_rid[slot]))
        evict(slot)

    srv._evict_slot = spy
    rids = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
    out = srv.run()
    mismatches = sum(1 for rid, want in zip(rids, ref_tokens) if out.get(rid) != want)
    resumed_ok = sum(1 for rid, want in zip(rids, ref_tokens)
                     if rid in preempted_rids and out.get(rid) == want)
    ledger_final = _ledger_kv_occupied_bytes()
    return {
        "eviction_preemptions": srv.n_preemptions,
        "eviction_swap": srv.n_swap_evictions,
        "eviction_recompute": srv.n_recompute_evictions,
        "eviction_resumed_identical": resumed_ok,
        "eviction_token_mismatches": mismatches,
        "eviction_leaked_pages": srv.n_pages - 1 - srv.free_pages,
        "eviction_ledger_baseline_bytes": ledger_baseline,
        "eviction_ledger_final_bytes": ledger_final,
        "eviction_ledger_balanced": int(ledger_final <= ledger_baseline + 0.5),
    }


# ---------------------------------------------------------------------------
# migration smoke: the two-host (subprocess-simulated) shrink, under fault
# ---------------------------------------------------------------------------

_DONOR_FLAG = "--serve-migration-donor"


def _donor_main(npz_path: str, device: str = "cpu") -> None:
    """Subprocess body: the DONOR HOST. Waits for the state snapshot (what a
    real donor host would hold live; written whole, then renamed), loads it,
    registers every leaf with its device
    server's StateDonor, prints the bound address as a JSON line, and
    serves P2P streams until stdin closes. Wire faults ride
    ``DSML_CHAOS_WIRE`` in this process's env — the donor is the stream
    SENDER, so drop/corrupt/delay happen on its pushes."""
    import json as _json
    import sys

    from dsml_tpu_torch.comm.device_server import serve_device

    while not os.path.exists(npz_path):  # the donor boots before its state is written
        time.sleep(0.05)
    blob = np.load(npz_path)
    # the staging allocator gets the upper half of the registry: twice the
    # largest piece plus the landing headroom
    biggest = max(blob[k].nbytes for k in blob.files)
    handle = serve_device(97, mem_size=max(0x200000, 4 * int(biggest)), device=device)
    for key in blob.files:
        if key == "__migration_version__":
            handle.runtime.donor.version = int(blob[key])
            continue
        handle.runtime.donor.register_array(key, blob[key])
    print(_json.dumps({"address": handle.address, "keys": len(blob.files)}), flush=True)
    sys.stdin.read()  # parent closes the pipe → exit
    handle.stop()


def _export_state_npz(path: str, host, version: int) -> int:
    """Host-state snapshot in the donor registry's key scheme (tree paths
    under ``params/`` / ``opt_state/`` — the migrator's keys), stamped with
    the snapshot's training step so the receiver can refuse a stale donor.
    bf16 leaves travel as float32 values."""
    arrays = {"__migration_version__": np.asarray(version)}
    arrays.update(host.arrays())
    with open(path + ".part", "wb") as f:  # renamed whole: the donors wait for it
        np.savez(f, **arrays)
    os.replace(path + ".part", path)
    return len(arrays) - 1


def run_migration_smoke(tmp_dir: str | None = None, reps: int = 1, device: str = "cuda",
                        cfg=None, threads: int | None = None,
                        planner_overrides: dict | None = None,
                        pool=None, shard_axis: str = "tp") -> dict:
    """The two-host shrink acceptance run: host A (this process's pool)
    shards GPT-2 (``cfg``, default tiny) over [dp=2, ``shard_axis``=2] on
    four slots (``"tp"``, as the JAX smoke's [dp=4, tp=2]; ``"fsdp"`` for a
    vocabulary tp does not divide, GPT-2's 50257), loses its local holder
    of shard 1 (slot 1), and the surviving copy of that shard lives only on
    "host B" (slots 2 and 3, non-addressable) — a donor
    SUBPROCESS serving the state over the real gRPC P2P streams, routed
    through the coordinator's membership table. Four legs:

    - ``refusal`` — without a migrator the pull refuses loudly;
    - ``clean`` — the same shrink completes via P2P migration, no
      checkpoint restore, state BIT-IDENTICAL to what the checkpoint
      fallback gives;
    - ``drop`` — one dropped StreamSend: the migrator harvests the partial
      prefix and resumes from the offset; same bits;
    - ``corrupt`` — every push corrupted: per-chunk CRC32C fires, the
      migration aborts cleanly, and an ``ElasticController`` riding the
      same failure falls back to the coordinated checkpoint restore with
      zero silent corruption.

    ``pool`` (a ``parallel.world.WorkerPool`` of at least four slots, all
    alive) runs the smoke's worlds when given, else one is made on
    ``device``; the corrupt leg's kill leaves its slot 1 dead (a caller
    that goes on with the pool restores it).
    ``verify_migration`` lists the violations."""
    import json
    import shutil
    import subprocess
    import sys
    import tempfile
    import time as _time

    from dsml_tpu_torch.checkpoint import CheckpointManager
    from dsml_tpu_torch.comm.coordinator import CoordinatorConfig, serve_coordinator
    from dsml_tpu_torch.comm.device_server import serve_device
    from dsml_tpu_torch.comm.migration import MigrationConfig, MigrationError, ShardMigrator
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.parallel import elastic
    from dsml_tpu_torch.parallel.mesh import MeshSpec
    from dsml_tpu_torch.parallel.world import TrainRecipe, WorkerPool
    from dsml_tpu_torch.runtime.controller import ControllerConfig, DeviceLost, ElasticController

    base = tmp_dir or tempfile.mkdtemp(prefix="dsml_migrate_")
    created = tmp_dir is None
    report: dict = {}
    procs: list = []
    coordinator = None
    receivers: list = []
    own_pool = pool is None
    cfg = cfg or GPT2Config.tiny()
    recipe = TrainRecipe(cfg, lr=1e-2)
    if own_pool:
        pool = WorkerPool(4, recipe, device=device, workdir=os.path.join(base, "pool"),
                          threads=threads)
    pool_recipe, pool.recipe = pool.recipe, recipe  # the smoke's worlds run its recipe
    device = pool.device
    if planner_overrides is None:
        planner_overrides = default_planner_overrides(device, 4)
    world = None
    try:
        global_batch = 8
        rng = np.random.default_rng(0)
        data = rng.integers(0, cfg.vocab_size, (16, global_batch, cfg.max_seq)).astype(np.int32)

        def batch_provider(step: int):
            x = data[step - 1]
            return x, np.roll(x, -1, 1).astype(np.int32)

        npz = os.path.join(base, "donor_state.npz")

        def spawn_donor(wire_spec: str):
            env = dict(os.environ)
            env.pop("DSML_CHAOS_WIRE", None)
            if wire_spec:
                env["DSML_CHAOS_WIRE"] = wire_spec
            p = subprocess.Popen(
                [sys.executable, "-m", "dsml_tpu_torch.runtime.chaos", _DONOR_FLAG, npz,
                 "--device", device],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, text=True)
            procs.append(p)
            return p

        def donor_address(p) -> str:
            line = p.stdout.readline()
            if not line:
                raise RuntimeError("the migration donor exited before serving")
            return json.loads(line)["address"]

        # the three legs' donors boot at once (each its own wire-fault plan),
        # while host A trains: they wait for the snapshot file
        donors = {spec_: spawn_donor(spec_) for spec_ in ("", "drop@1", "corrupt@*")}

        # host A's live state: 2 steps on [dp=2, shard_axis=2] (slot i holds
        # shard i%2 — losing slot 1 removes every LOCAL copy of shard 1;
        # slots 2 and 3 play host B, so the shard SURVIVES, remotely)
        spec = MeshSpec(dp=2, **{shard_axis: 2})
        slots = [0, 1, 2, 3]
        ckpt_dir = os.path.join(base, "ckpt")
        world = pool.form(slots, spec, seed=0, ckpt_dir=ckpt_dir)
        for s in (1, 2):
            world.step(*batch_provider(s))
        world.save(2, {"step": 2, "lineage": "pure"})
        world.wait_saves()
        manager = CheckpointManager(ckpt_dir, max_to_keep=None)
        host = world.state()
        n_leaves = _export_state_npz(npz, host, version=2)
        host.remove()

        lost = [1]
        survivors = [0, 2, 3]
        remote = (2, 3)
        biggest = max(int(np.prod(shape)) * 4 for shape, _, _ in world.layout.values())
        coordinator = serve_coordinator(config=CoordinatorConfig(health_interval_s=3600.0))


        def migrator_for(donor_addr: str, **cfg_kw) -> ShardMigrator:
            # a receiver server a leg: each donor numbers its streams from 1,
            # and a leg must not meet the last one's terminal stream ids
            recv = serve_device(90 + len(receivers), mem_size=max(0x400000, 4 * biggest),
                                device=device)
            receivers.append(recv)
            comm = coordinator.runtime.comm_init(2, [recv.address, donor_addr])
            self_rank, donors = coordinator.runtime.broker_migration(
                comm.comm_id, recv.runtime.device_id)
            return ShardMigrator(recv.runtime, self_rank, donors,
                                 config=MigrationConfig(**cfg_kw),
                                 local_address=recv.runtime.bound_address, expect_version=2)

        def pull_with(migrator):
            """The reconfigure's pull: the state onto the survivors' host."""
            h = elastic._pull_host_state(world, lost, migrator=migrator,
                                         non_addressable=remote)
            try:
                return h.tree()
            finally:
                h.remove()

        # --- leg 0: the refusal (no migrator) -----------------------------
        try:
            pull_with(None)
            report["refusal"] = {"raised": False}
        except RuntimeError as e:
            report["refusal"] = {"raised": True,
                                 "mentions_non_addressable": "non-addressable" in str(e)}

        # --- leg 1: clean migration vs checkpoint fallback, bit-identical -
        donor_addr = donor_address(donors[""])
        mig = migrator_for(donor_addr, timeout_s=60.0)
        mig_walls, fb_walls = [], []
        state = fb_state = None
        for _ in range(max(reps, 1)):
            t0 = _time.perf_counter()
            state = pull_with(mig)
            mig_walls.append((_time.perf_counter() - t0) * 1e3)
            t0 = _time.perf_counter()
            fb = elastic._host_from_checkpoint(manager, 2, pool)
            try:
                fb_state = fb.tree()
            finally:
                fb.remove()
            fb_walls.append((_time.perf_counter() - t0) * 1e3)
        report["clean"] = {
            "migrated_pieces": mig.stats["pieces"],
            "migrated_bytes": mig.stats["bytes"],
            "migration_ms": round(mig.stats["ms"], 3),
            "mb_s": round((mig.stats["bytes"] / 1e6) / max(mig.stats["ms"] / 1e3, 1e-9), 3),
            "reps": max(reps, 1),
            "recovery_ms_migration": [round(w, 3) for w in mig_walls],
            "recovery_ms_fallback": [round(w, 3) for w in fb_walls],
            "bit_identical_to_fallback": _bit_identical(
                (state["params"], state["opt_state"]),
                (fb_state["params"], fb_state["opt_state"])),
            "used_fallback": False,
        }
        mig.close()

        # --- leg 2: one dropped StreamSend → harvested prefix + resume ----
        donor_addr = donor_address(donors["drop@1"])
        mig = migrator_for(donor_addr, timeout_s=60.0)
        drop_state = pull_with(mig)
        report["drop"] = {
            "resumed": mig.stats["resumed"],
            "retries": mig.stats["retries"],
            "bit_identical": _bit_identical(
                (drop_state["params"], drop_state["opt_state"]),
                (state["params"], state["opt_state"])),
        }
        mig.close()
        world.leave()
        world = None

        # --- leg 3: persistent corruption → CRC fires, the controller falls
        # back to the coordinated checkpoint restore, zero silent landing --
        donor_addr = donor_address(donors["corrupt@*"])
        mig = migrator_for(donor_addr, timeout_s=30.0, retries=1)
        crc_fired = False
        world = pool.form(slots, spec, seed=0)
        try:
            elastic._pull_host_state(world, lost, migrator=mig, non_addressable=remote).remove()
        except MigrationError:
            crc_fired = True
        world.leave()
        world = None

        fleet = VirtualFleet(slots, pool)
        ctl = ElasticController(
            pool, batch_provider, checkpoint_dir=os.path.join(base, "ctl"), fleet=fleet,
            slots=slots, spec=spec, config=ControllerConfig(checkpoint_every=2, growback="keep"),
            global_batch=global_batch, seed=0, migrator=mig, non_addressable=remote,
            planner_overrides=planner_overrides)

        def on_step(s: int) -> None:
            if s == 3:
                dead = fleet.kill(1)
                if dead:
                    ctl.inject(DeviceLost(dead, "chaos: local tp-1 holder"))

        with ctl:
            ctl_report = ctl.run(4, on_step=on_step)
        rec = ctl_report["recoveries"][0] if ctl_report["recoveries"] else {}
        report["corrupt"] = {
            "crc_fired": crc_fired,
            "integrity_failures": mig.stats["integrity_failures"],
            "controller_kind": rec.get("kind"),
            "controller_fallback_mentions_crc": "CRC" in rec.get("fallback_reason", ""),
            "controller_steps_completed": ctl_report["steps_completed"],
            "losses_finite": bool(np.all(np.isfinite(list(ctl.losses.values())))),
        }
        mig.close()
        report["n_leaves"] = n_leaves
        manager.close()
        return report
    finally:
        if world is not None:
            world.leave()
        if coordinator is not None:
            coordinator.stop()
        for recv in receivers:
            recv.stop()
        for p in procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=30)
            except Exception:  # noqa: BLE001 — teardown must not mask the report
                p.kill()
                p.wait()
        pool.recipe = pool_recipe
        if own_pool:
            pool.close()
        if created:
            shutil.rmtree(base, ignore_errors=True)


def verify_migration(report: dict) -> list[str]:
    """The migration invariants, as a list of violations (empty = pass)."""
    bad: list[str] = []
    if not report.get("refusal", {}).get("raised"):
        bad.append("refusal: pull without a migrator did NOT raise")
    clean = report.get("clean", {})
    if not clean.get("migrated_pieces"):
        bad.append("clean: zero pieces moved over P2P streams")
    if clean.get("used_fallback"):
        bad.append("clean: migration leg used the checkpoint fallback")
    if not clean.get("bit_identical_to_fallback"):
        bad.append("clean: migrated state NOT bit-identical to the checkpoint-fallback state")
    drop = report.get("drop", {})
    if not (drop.get("resumed") or drop.get("retries")):
        bad.append("drop: dropped stream neither resumed nor retried")
    if not drop.get("bit_identical"):
        bad.append("drop: resumed migration NOT bit-identical")
    corrupt = report.get("corrupt", {})
    if not corrupt.get("crc_fired"):
        bad.append("corrupt: CRC check did not abort the migration")
    if not corrupt.get("integrity_failures"):
        bad.append("corrupt: no integrity failures counted")
    if corrupt.get("controller_kind") != "checkpoint_fallback":
        bad.append(f"corrupt: controller recovered via {corrupt.get('controller_kind')!r}, "
                   "expected checkpoint_fallback")
    if corrupt.get("controller_steps_completed", 0) < 4:
        bad.append("corrupt: controller did not complete the run after fallback")
    return bad


def verify(report: dict) -> list[str]:
    """The invariants, as a list of violations (empty = pass)."""
    bad: list[str] = []
    runs = [(k, v) for k, v in report.items() if isinstance(v, dict) and "steps_completed" in v]
    for name, rep in runs:
        if rep["steps_completed"] != report["n_steps"]:
            bad.append(f"{name}: lost steps — completed "
                       f"{rep['steps_completed']}/{report['n_steps']}")
        if rep["kills"] and not rep["recoveries"]:
            bad.append(f"{name}: {rep['kills']} kills but zero recoveries")
        if not rep.get("bit_identical"):
            bad.append(f"{name}: final params NOT bit-identical to the uninterrupted run")
        if rep["goodput"] < report["goodput_floor"]:
            bad.append(f"{name}: goodput {rep['goodput']} below the documented floor "
                       f"{report['goodput_floor']}")
    if not runs:
        bad.append("no chaos runs in the report")
    staging = report.get("ledger_staging_bytes_final", 0)
    if staging > 0:
        bad.append(f"ledger: {staging:.0f} staging byte(s) still claimed after every recovery "
                   "completed — a checkpoint snapshot or migration span leaked past its commit")
    srv = report.get("serving")
    if srv is not None and srv.get("token_mismatches", 0) > 0:
        bad.append(f"serving: {srv['token_mismatches']} request(s) lost or changed tokens "
                   "across a replica kill")
    fleet = report.get("serving_fleet")
    if fleet is not None:
        if fleet.get("token_mismatches", 0) > 0:
            bad.append(f"serving_fleet: {fleet['token_mismatches']} request(s) lost or changed "
                       "tokens across worker kills")
        if not fleet.get("requeued_prefill"):
            bad.append("serving_fleet: the prefill-worker kill interrupted no work — the "
                       "mid-handoff re-prefill path went unexercised")
        if not fleet.get("requeued_decode"):
            bad.append("serving_fleet: the decode-worker kill interrupted no work — the "
                       "full-pipeline re-run path went unexercised")
        if not fleet.get("trace_requeue_same", 1):
            bad.append("serving_fleet: a killed request's re-run retired under a DIFFERENT "
                       "trace_id — the retry must stay on the same trace")
        if not fleet.get("trace_retry_recorded", 1):
            bad.append("serving_fleet: a requeued request retired with zero recorded retries")
        if not fleet.get("trace_burn_full_latency", 1):
            bad.append("serving_fleet: a requeued request's SLO burn counted only the "
                       "post-requeue leg — the budget must pay the FULL user-visible latency")
    paged = report.get("serving_paged")
    if paged is not None:
        if paged.get("token_mismatches", 0) > 0:
            bad.append(f"serving_paged: {paged['token_mismatches']} request(s) lost or changed "
                       "tokens across the decode-worker kill")
        if not paged.get("requeued_decode"):
            bad.append("serving_paged: the decode-worker kill interrupted no work")
        if not paged.get("peak_shared_pages"):
            bad.append("serving_paged: no CoW prefix page was ever shared — the kill did not "
                       "land with sharing live")
        if paged.get("leaked_pages", 0) > 0:
            bad.append(f"serving_paged: {paged['leaked_pages']} pool page(s) leaked past "
                       "request retirement")
        if not paged.get("eviction_preemptions"):
            bad.append("serving_paged: the eviction leg forced no preemption")
        if not paged.get("eviction_resumed_identical"):
            bad.append("serving_paged: no preempted request resumed with the reference tokens")
        if paged.get("eviction_token_mismatches", 0) > 0:
            bad.append(f"serving_paged: {paged['eviction_token_mismatches']} request(s) changed "
                       "tokens across an eviction/resume")
        if paged.get("eviction_leaked_pages", 0) > 0:
            bad.append(f"serving_paged: {paged['eviction_leaked_pages']} page(s) leaked through "
                       "the preemption tier")
        if not paged.get("ledger_balanced", 1):
            bad.append("serving_paged: ledger KV bytes did not return to baseline after the "
                       f"drain ({paged.get('ledger_kv_final_bytes')} vs "
                       f"{paged.get('ledger_kv_baseline_bytes')} baseline)")
        if not paged.get("eviction_ledger_balanced", 1):
            bad.append("serving_paged: eviction leg leaked ledger KV bytes "
                       f"({paged.get('eviction_ledger_final_bytes')} vs "
                       f"{paged.get('eviction_ledger_baseline_bytes')} baseline)")
    return bad


def _main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="chaos smoke: the scripted kill/restore schedule on eight rank slots; "
        "exits nonzero if any survival invariant fails")
    parser.add_argument("--steps", type=int, default=24)
    parser.add_argument("--seeds", type=int, nargs="*", default=[],
                        help="extra seeded-random schedules")
    parser.add_argument("--report", default="", help="write the JSON report here")
    parser.add_argument("--device", default="cuda",
                        help="where the slots run: cuda (every slot on the card) or cpu")
    parser.add_argument("--threads", type=int, default=None,
                        help="torch threads a slot (default: cores / (2 × slots), at least 1)")
    parser.add_argument("--migration", action="store_true",
                        help="run the two-host (subprocess-simulated) shard-migration smoke "
                        "instead: clean P2P shrink bit-identical to the checkpoint fallback, "
                        "dropped-stream resume, corrupt-chunk CRC abort + coordinated "
                        "fallback; exits nonzero on any violated invariant")
    parser.add_argument(_DONOR_FLAG, default=None, metavar="NPZ", help=argparse.SUPPRESS)
    parser.add_argument("--cluster-snapshot", default="",
                        help="write this process's cluster-obs snapshot here")
    parser.add_argument("--push", default="",
                        help="push the snapshot to a running aggregator at this host:port")
    args = parser.parse_args(argv)

    if args.serve_migration_donor is not None:
        _donor_main(args.serve_migration_donor, args.device)
        return 0
    from dsml_tpu_torch.utils.platform import resolve_device

    device = str(resolve_device(args.device))  # raises without the card: no fallback
    threads = args.threads

    if args.migration:
        report = run_migration_smoke(device=device, threads=threads)
        violations = verify_migration(report)
        report["violations"] = violations
        line = json.dumps(report, default=str)
        print(line)
        if args.report:
            with open(args.report, "w") as f:
                f.write(line + "\n")
        for v in violations:
            log.error("migration invariant violated: %s", v)
        return 1 if violations else 0

    want_obs = bool(args.cluster_snapshot or args.push)
    if want_obs:
        from dsml_tpu_torch import obs as _obs

        _obs.enable(forensics=False)
    env_schedule = config_from_env()
    if env_schedule is not None:
        log.info("DSML_CHAOS schedule: %d events", len(env_schedule.events))
    report = run_smoke(n_steps=args.steps, seeds=tuple(args.seeds), schedule=env_schedule,
                       device=device, threads=threads)
    violations = verify(report)
    report["violations"] = violations
    line = json.dumps(report, default=str)
    print(line)
    if args.report:
        with open(args.report, "w") as f:
            f.write(line + "\n")
    if want_obs:
        from dsml_tpu_torch.obs import cluster as _cluster

        if args.cluster_snapshot:
            with open(args.cluster_snapshot, "w") as f:
                json.dump(_cluster.snapshot(role="chaos"), f)
        if args.push:
            try:
                _cluster.push_snapshot(args.push, role="chaos")
            except Exception as e:  # noqa: BLE001 — obs must not fail chaos
                log.warning("cluster push to %s failed: %r", args.push, e)
    for v in violations:
        log.error("chaos invariant violated: %s", v)
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(_main())
