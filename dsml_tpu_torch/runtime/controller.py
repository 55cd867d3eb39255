"""Elastic chaos-survival controller: ride preemptions end-to-end — the
counterpart of ``dsml_tpu/runtime/controller.py``.

The reference marks a communicator permanently dead on first failure
(recovery "none", SURVEY.md §5.3). This module is the loop::

    detect ──► shrink ──► resume ──► grow
      │          │           │         │
      │          │           │         └─ capacity returns: re-shard live
      │          │           │            state back onto the full fleet at
      │          │           │            the next checkpoint boundary
      │          │           │            ("keep"), or restore the last
      │          │           │            pure-lineage checkpoint and replay
      │          │           │            at full width ("replay" — final
      │          │           │            params bit-identical to a run
      │          │           │            that never failed)
      │          │           └─ the new world builds its step and the run
      │          │              continues mid-run, data-loader position
      │          │              intact (``batch_provider`` is a pure
      │          │              function of the step index)
      │          └─ ``elastic.reconfigure`` onto the survivors; when the
      │             audit reports torn leaves (an entire tp shard / pp
      │             stage / ZeRO shard died), fall back to
      │             ``elastic.restore_from_checkpoint`` and replay the steps
      │             since the last commit (the "lost work" metric)
      └─ three sources: the fleet view (a coordinator health verdict),
         ``DeviceLost`` signals (injected by the chaos harness, or a step
         whose rank died), and hangwatch deadline expiries followed by a
         fleet probe (a wedged-but-alive rank)

The port's devices are the rank slots of a ``parallel.world.WorkerPool``
(one long-lived process a slot; a slot id is the JAX code's device id). The
controller lives in the caller's process and never trains there: the
current ``World`` trains, saves (per-rank ``checkpoint.native.MeshShard``
checkpoints with ``wait=False``, ``lineage`` pure / mixed in ``meta``) and
restores; a recovery pulls the survivors' state to the host once and pushes
it into the new world once (``parallel.elastic``). ``params`` and
``opt_state`` return the host tree in the JAX layout (numpy).

Recovery time and lost work land in the obs registry
(``controller_recovery_ms{stage}`` through ``obs.observe_recovery_ms``,
``controller_recoveries_total{kind}``, ``controller_lost_steps_total``,
``controller_redone_steps_total``), the goodput marks and the flight
recorder. ``runtime.chaos`` drives scripted and seeded-random kill/restore
schedules against this loop and against the serving :class:`DecodeFleet`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable

import numpy as np

from dsml_tpu_torch.obs import (
    GoodputTracker,
    flight_recorder,
    get_registry,
    hangwatch,
    observe_recovery_ms,
)
from dsml_tpu_torch.parallel import elastic
from dsml_tpu_torch.parallel.elastic import ElasticPolicy
from dsml_tpu_torch.parallel.mesh import MeshSpec
from dsml_tpu_torch.utils.config import Config, field
from dsml_tpu_torch.utils.logging import get_logger

__all__ = [
    "DeviceLost",
    "Unrecoverable",
    "StaticFleet",
    "ControllerConfig",
    "ElasticController",
    "DecodeFleet",
]

log = get_logger("controller")


class DeviceLost(RuntimeError):
    """Failure signal: these slots are gone. Raised by a world's step when a
    rank died, injected by the chaos harness, or synthesized from a
    coordinator health verdict."""

    def __init__(self, devices, message: str = ""):
        self.devices = tuple(devices)
        super().__init__(
            message or f"lost {len(self.devices)} device(s): "
            f"{[getattr(d, 'id', d) for d in self.devices]}"
        )


class Unrecoverable(RuntimeError):
    """The job cannot continue: no survivors, or recovery itself failed."""


class StaticFleet:
    """The no-failure fleet view: a fixed slot list. The chaos harness plugs
    in ``chaos.VirtualFleet``."""

    def __init__(self, devices):
        self._devices = list(devices)

    def available(self) -> list:
        return list(self._devices)


@dataclasses.dataclass
class ControllerConfig(Config):
    checkpoint_every: int = field(
        8, help="async checkpoint cadence in steps; also the grow-back "
        "boundary — restored capacity is adopted right after a save commits"
    )
    keep_checkpoints: int = field(
        0, help="max checkpoints retained (0 = keep all; replay grow-back "
        "needs the last pure-lineage checkpoint to outlive the outage)"
    )
    growback: str = field(
        "replay", help="grow-back mode: 'replay' restores the last "
        "pure-lineage checkpoint and re-runs the outage window at full "
        "width (final params bit-identical to a never-failed run); 'keep' "
        "re-shards the survivor-width state onto the restored fleet (zero "
        "recompute, mixed-width lineage)"
    )
    detect_every: int = field(
        1, help="probe the fleet view every N steps (injected DeviceLost "
        "signals and hangwatch verdicts are checked every step regardless)"
    )
    recovery_deadline_s: float = field(
        0.0, help="recoveries slower than this warn + dump a postmortem "
        "bundle (0 = DSML_RECOVERY_DEADLINE_S, default 120)"
    )
    batch_per_device: int = field(1, help="forwarded to the elastic re-plan")
    attn_impl: str = field("", help="attention impl for rebuilt steps ('' = "
                           "per-mesh auto: ring2 on cp meshes, ring otherwise "
                           "— a pinned 'ring' on a cp mesh would lose ring2's "
                           "O(S/cp) residual property on every reconfigure)")

    def resolved_recovery_deadline_s(self) -> float:
        if self.recovery_deadline_s > 0:
            return self.recovery_deadline_s
        try:
            return float(os.environ.get("DSML_RECOVERY_DEADLINE_S", 120.0))
        except ValueError:
            return 120.0


def _slot(d):
    return getattr(d, "id", d)


class ElasticController:
    """Supervision loop over a hybrid-parallel training run on ``pool``'s
    slots (``parallel.world.WorkerPool``; its recipe at construction is the
    model, the optimizer and the step's options — ``config.attn_impl``,
    when set, replaces the recipe's).

    ``batch_provider(step) -> (x, y)`` must be a deterministic function of
    the 1-based step index: that is what makes the data-loader position a
    single integer that rides in every checkpoint manifest, and replay
    after a fallback bit-identical. ``slots`` and ``spec`` pin the full
    topology (the grow-back target; default: the planner's choice over the
    fleet's available slots). ``failure_feed`` is a zero-arg callable
    returning slot ids declared dead (``comm.coordinator``'s
    ``failure_feed``). ``on_recover(record)``, when set, is called after
    each recovery with its record, the new world in place."""

    def __init__(
        self,
        pool,
        batch_provider: Callable[[int], tuple],
        checkpoint_dir: str,
        fleet=None,
        slots=None,
        spec: MeshSpec | None = None,
        config: ControllerConfig | None = None,
        policy: ElasticPolicy = ElasticPolicy(),
        global_batch: int | None = None,
        seed: int = 0,
        failure_feed: Callable[[], list] | None = None,
        planner_overrides: dict | None = None,
        migrator=None,
        non_addressable=(),
        on_recover: Callable[[dict], None] | None = None,
    ):
        from dsml_tpu_torch.checkpoint import CheckpointManager

        self.pool = pool
        self.on_recover = on_recover
        self.batch_provider = batch_provider
        self.config = config or ControllerConfig()
        self.recipe = pool.recipe
        if self.config.attn_impl:
            self.recipe = dataclasses.replace(self.recipe, attn_impl=self.config.attn_impl)
        self.policy = policy
        self.global_batch = global_batch
        self.seed = seed
        self.planner_overrides = planner_overrides
        self.migrator = migrator
        self.non_addressable = tuple(_slot(d) for d in non_addressable)
        self._failure_feed = failure_feed
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        self._ckpt = CheckpointManager(self.checkpoint_dir,
                                       max_to_keep=self.config.keep_checkpoints or None)
        self._registry = get_registry()
        self._recorder = flight_recorder.get_flight_recorder()
        hw_cfg = hangwatch.config_from_env()
        self._hw = hangwatch.get_hangwatch() if hw_cfg is not None else None
        self._hw_deadline = (hangwatch.TrailingDeadline.from_config(hw_cfg)
                             if hw_cfg is not None else None)
        self._hw_fired_seen = len(self._hw.fired) if self._hw is not None else 0

        if fleet is None:
            fleet = StaticFleet(pool.alive())
        self.fleet = fleet
        devices = [_slot(d) for d in fleet.available()]
        if not devices:
            raise Unrecoverable("fleet has no available devices")
        if slots is not None:
            used = list(slots)
            self._full_spec = (spec or MeshSpec()).resolved(len(used))
        elif spec is not None:
            used = devices
            self._full_spec = spec.resolved(len(used))
        else:
            plan, used = elastic._plan_for_survivors(
                self.recipe, self.recipe.n_params(), devices, self.config.batch_per_device,
                global_batch, planner_overrides, pool.device)
            self._full_spec = plan.spec
        self._full_slots = list(used)
        self._full_ids = frozenset(used)
        self.world = self._form(self._full_slots, self._full_spec, seed)
        self.spec = self.world.spec
        self._n_params = self.recipe.n_params()

        # bookkeeping: 1-based index of the NEXT step to run; walls of the
        # steps in the CURRENT lineage (a rewind pops the discarded suffix
        # into lost work); pure = every step since init ran at full width
        self._step = 1
        self._pure = True
        self._lineage_walls: dict[int, float] = {}
        self._lost_work_s = 0.0
        self._redone_steps = 0
        self._injected: deque[DeviceLost] = deque()
        self._mid_step: dict[int, int] = {}
        # slots reported lost by a SIGNAL that the fleet view still lists:
        # a StaticFleet never stops listing a dead slot, so without this
        # quarantine the next grow boundary would re-adopt it. A
        # health-aware fleet clears it by dropping the slot from available()
        # at least once — after that, its reappearance is a genuine restore
        self._quarantined: set = set()
        self.recoveries: list[dict] = []
        self.losses: dict[int, float] = {}
        self._goodput = GoodputTracker(registry=self._registry)
        self._t0 = time.monotonic()
        self._registry.gauge("controller_fleet_size",
                             "devices in the controller's mesh").set(len(devices))

    # ---- public surface --------------------------------------------------

    @property
    def mesh(self):
        return self.world

    def host_state(self) -> dict:
        """The current state on the host, ``{"params", "opt_state"}`` in the
        JAX layout (numpy; the pull of a recovery)."""
        host = self.world.state()
        try:
            return host.tree()
        finally:
            host.remove()

    @property
    def params(self):
        return self.host_state()["params"]

    @property
    def opt_state(self):
        return self.host_state()["opt_state"]

    def inject(self, signal: DeviceLost) -> None:
        """Queue a failure signal (the chaos harness's hook; a coordinator
        adapter pushes health verdicts through the same door)."""
        self._injected.append(signal)

    def kill_mid_step(self, step: int, slot: int) -> None:
        """Chaos hook: at step ``step`` the rank of ``slot`` SIGKILLs itself
        after its backward, before the gradient sync; the step surfaces a
        ``DeviceLost`` and is retried on the survivors."""
        self._mid_step[step] = slot

    def run(self, n_steps: int, on_step: Callable[[int], None] | None = None) -> dict:
        """Drive training to ``n_steps`` completed steps, riding every
        failure the fleet/chaos throws. ``on_step(step)`` fires before each
        step's detection pass (the chaos harness's injection point).
        Returns :meth:`report`."""
        while self._step <= n_steps:
            step = self._step
            if on_step is not None:
                on_step(step)
            self._detect(step)
            x, y = self.batch_provider(step)
            hw_token = None
            if self._hw is not None:
                deadline = self._hw_deadline.timeout_s()
                if deadline is not None:
                    hw_token = self._hw.arm("controller_step", deadline, step=step)
            t0 = time.perf_counter()
            try:
                loss = self.world.step(x, y, die_before_sync=self._mid_step.pop(step, None))
            except DeviceLost as e:
                # a rank died inside the step: the survivors raised before
                # their optimizer step, so recover and RETRY the same step
                # index — nothing is skipped
                surfaced = time.perf_counter() - t0
                self._recover(list(e.devices),
                              extra={"surfaced_s": round(surfaced, 6), "mid_step": step})
                continue
            finally:
                if hw_token is not None:
                    self._hw.disarm(hw_token)
            wall = time.perf_counter() - t0
            if self._hw is not None:
                self._hw_deadline.observe(wall)
            self._lineage_walls[step] = wall
            self._goodput.add_productive(wall)
            self.losses[step] = float(loss)
            self._recorder.record("controller_step", step=step, wall_ms=round(wall * 1e3, 3),
                                  width=self.spec.n_devices)
            self._step += 1
            if step % max(self.config.checkpoint_every, 1) == 0:
                self._save(step)
                self._maybe_grow(step)
        return self.report()

    def close(self) -> None:
        try:
            if self.world.active:
                try:
                    self.world.wait_saves()
                finally:
                    self.world.leave()
        finally:
            self._ckpt.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def report(self) -> dict:
        wall = time.monotonic() - self._t0
        productive = sum(self._lineage_walls.values())
        recov_ms = [r["recovery_ms"] for r in self.recoveries]
        out = {
            "steps_completed": self._step - 1,
            "width": self.spec.n_devices,
            "pure_lineage": self._pure,
            "recoveries": list(self.recoveries),
            "n_recoveries": len(self.recoveries),
            "redone_steps": self._redone_steps,
            "lost_work_s": round(self._lost_work_s, 6),
            "wall_s": round(wall, 6),
            "productive_s": round(productive, 6),
            "goodput": round(min(productive / max(wall, 1e-9), 1.0), 4),
        }
        if recov_ms:
            out["recovery_p50_ms"] = round(float(np.percentile(recov_ms, 50)), 3)
            out["recovery_p99_ms"] = round(float(np.percentile(recov_ms, 99)), 3)
        return out

    # ---- internals -------------------------------------------------------

    def _form(self, slots, spec, seed):
        return self.pool.form(slots, spec, seed=seed, ckpt_dir=self.checkpoint_dir,
                              max_to_keep=self.config.keep_checkpoints, recipe=self.recipe)

    def _save(self, step: int) -> None:
        t0 = time.perf_counter()
        lineage = "pure" if self._pure else "mixed"
        self.world.save(step, meta={"step": step, "lineage": lineage,
                                    "width": self.spec.n_devices,
                                    "spec": self.spec.sizes_dict()},
                        iterator_state={"step": step})
        self._recorder.record("controller_checkpoint", step=step, lineage=lineage,
                              stall_ms=round((time.perf_counter() - t0) * 1e3, 3))

    def _detect(self, step: int) -> None:
        """Run all three detection sources; recover if any fires."""
        lost: list = []
        seen: set = set()

        def note(devs):
            for d in devs:
                if _slot(d) not in seen:
                    seen.add(_slot(d))
                    lost.append(_slot(d))

        while self._injected:
            note(self._injected.popleft().devices)
        if self._failure_feed is not None:
            # the feed speaks slot ids (coordinator verdicts): those of the
            # live world count
            note([i for i in (self._failure_feed() or []) if _slot(i) in self.world.slots])
        probe = bool(lost) or step % max(self.config.detect_every, 1) == 0
        if self._hw is not None:
            fired = len(self._hw.fired)
            if fired > self._hw_fired_seen:
                # a deadline expiry is a VERDICT to verify: probe the fleet
                # now (a slow-but-healthy step is a false alarm it clears)
                self._hw_fired_seen = fired
                self._recorder.record("controller_hang_verdict", step=step)
                probe = True
        if probe:
            avail = {_slot(d) for d in self.fleet.available()}
            self._quarantined -= {i for i in self._quarantined if i not in avail}
            note([s for s in self.world.slots if s not in avail])
        if lost:
            self._recover(lost)

    def _leave_broken(self) -> None:
        """Settle the live ranks' saves (a commit the abort broke is
        dropped) and leave the current world."""
        if not self.world.active:
            return
        try:
            self.world.wait_saves()
        except Exception as e:  # noqa: BLE001 — the world is being abandoned
            log.warning("saves in flight at the failure dropped: %s", e)
        self.world.leave()

    def _recover(self, lost_slots, extra: dict | None = None) -> None:
        """shrink (or checkpoint-fallback) onto the survivors."""
        t0 = time.perf_counter()
        lost_ids = {_slot(d) for d in lost_slots}
        self._quarantined |= lost_ids
        width_before = self.spec.n_devices
        self._goodput.mark("preemption", step=self._step, lost=sorted(lost_ids))
        self._recorder.record("controller_detect", step=self._step, lost=sorted(lost_ids),
                              width=width_before)
        survivors = [_slot(d) for d in self.fleet.available()
                     if _slot(d) not in lost_ids and _slot(d) not in self._quarantined
                     and self.pool.is_alive(_slot(d))]
        if not survivors:
            raise Unrecoverable(f"no surviving devices after losing {sorted(lost_ids)}")
        lost_in_mesh = [s for s in self.world.slots if s in lost_ids]
        lost_steps = 0
        extra = dict(extra or {})
        mig_before = None
        not_recoverable: tuple = (elastic.StateNotRecoverable,)
        if self.migrator is not None:
            from dsml_tpu_torch.comm.migration import MigrationError

            not_recoverable += (MigrationError,)
            # donor death verdicts and cached plans are scoped to ONE recovery
            if hasattr(self.migrator, "reset_donors"):
                self.migrator.reset_donors()
            mig_before = dict(self.migrator.stats)
        try:
            state = elastic.reconfigure(
                self.world, survivors, lost_in_mesh, policy=self.policy,
                batch_per_device=self.config.batch_per_device, global_batch=self.global_batch,
                planner_overrides=self.planner_overrides, migrator=self.migrator,
                non_addressable=self.non_addressable)
            kind = "reconfigure"
        except not_recoverable as e:
            # torn state (or P2P migration undeliverable): the Varuna-style
            # coordinated fallback — settle the saves, restore the latest
            # commit onto the survivor plan, rewind the step counter to it.
            # Any other error (the fail-fast policy, a worker's command
            # failing on the card) is no torn state: it propagates
            log.warning("live state not recoverable (%s); falling back to checkpoint", e)
            extra["fallback_reason"] = str(e)[:200]
            self._leave_broken()
            try:
                state = elastic.restore_from_checkpoint(
                    self._ckpt, self.pool, survivors,
                    batch_per_device=self.config.batch_per_device,
                    global_batch=self.global_batch, planner_overrides=self.planner_overrides,
                    recipe=self.recipe)
            except FileNotFoundError as fe:
                raise Unrecoverable(f"state torn and no checkpoint to fall back to: {fe}") from e
            lost_steps = max((self._step - 1) - state.step, 0)
            self._rewind(state.step)
            kind = "checkpoint_fallback"
        if mig_before is not None:
            stats = self.migrator.stats
            delta = {k: stats[k] - mig_before[k] for k in mig_before}
            if delta.get("pieces") or delta.get("bytes") or \
                    delta.get("integrity_failures") or delta.get("retries"):
                extra.update({
                    "migrated_pieces": delta["pieces"],
                    "migrated_bytes": delta["bytes"],
                    "migration_resumed": delta["resumed"],
                    "migration_integrity_failures": delta["integrity_failures"],
                })
        extra.update({k: round(v, 6) for k, v in state.timings.items()})
        extra["plan"] = list(state.reasons)
        self._adopt(state)
        self._pure = False
        recovery_ms = (time.perf_counter() - t0) * 1e3
        self._finish_recovery(kind, recovery_ms, width_before, lost_steps, sorted(lost_ids),
                              extra=extra)

    def _adopt(self, state) -> None:
        self.world, self.spec = state.world, state.spec
        self._registry.gauge("controller_fleet_size",
                             "devices in the controller's mesh").set(self.spec.n_devices)

    def _rewind(self, to_step: int) -> None:
        """Discard the lineage suffix past ``to_step`` (it will be redone):
        its walls move from productive to lost work, and the step counter
        returns to the step after the restored one."""
        discarded = [s for s in self._lineage_walls if s > to_step]
        lost_s = sum(self._lineage_walls.pop(s) for s in discarded)
        self._lost_work_s += lost_s
        self._redone_steps += len(discarded)
        self._goodput.add_productive(-lost_s)  # no longer useful work
        for s in discarded:
            self.losses.pop(s, None)
        self._step = to_step + 1

    def _finish_recovery(self, kind: str, recovery_ms: float, width_before: int,
                         lost_steps: int, lost_ids: list, extra: dict | None = None) -> None:
        observe_recovery_ms(kind, recovery_ms, self._registry)
        self._registry.counter("controller_recoveries_total", "controller recovery actions",
                               labels=("kind",)).inc(kind=kind)
        # two DISTINCT counters: lost = work the FAILURE destroyed (a
        # fallback rewound past the last commit); redone = work the replay
        # grow-back deliberately discards for a pure lineage
        if lost_steps and kind == "checkpoint_fallback":
            self._registry.counter("controller_lost_steps_total",
                                   "steps rewound to a checkpoint and replayed").inc(lost_steps)
        if lost_steps and kind == "grow_replay":
            self._registry.counter("controller_redone_steps_total",
                                   "steps discarded by a replay grow-back and re-run"
                                   ).inc(lost_steps)
        self._goodput.mark("restore", kind=kind)
        # ledger watermark at the recovery boundary (the supervisor's own
        # claims; the ranks' are in their processes)
        from dsml_tpu_torch.obs.memory import get_memory_ledger

        get_memory_ledger(self._registry).note_step_peak(self._step, label=f"recovery:{kind}")
        rec = {
            "kind": kind, "recovery_ms": round(recovery_ms, 3),
            "from_width": width_before, "to_width": self.spec.n_devices,
            "lost_steps": lost_steps, "lost_devices": lost_ids,
            "resume_step": self._step, "slots": list(self.world.slots),
        }
        rec.update(extra or {})
        self.recoveries.append(rec)
        self._recorder.record(
            "controller_recovered",
            **{("recovery_kind" if k == "kind" else k): v for k, v in rec.items()})
        log.warning("recovered (%s) in %.0f ms: width %d -> %d, resume at step %d%s", kind,
                    recovery_ms, width_before, self.spec.n_devices, self._step,
                    f", {lost_steps} step(s) to replay" if lost_steps else "")
        deadline_s = self.config.resolved_recovery_deadline_s()
        if recovery_ms > deadline_s * 1e3:
            log.error("recovery exceeded its %.0fs deadline (%.0f ms) — dumping postmortem "
                      "bundle", deadline_s, recovery_ms)
            try:
                self._recorder.dump("slow_recovery", extra=rec)
            except Exception:  # noqa: BLE001 — never mask the recovery
                pass
        if self.on_recover is not None:
            self.on_recover(rec)

    def _maybe_grow(self, step: int) -> None:
        """At a checkpoint boundary, adopt restored capacity."""
        avail = [_slot(d) for d in self.fleet.available()
                 if _slot(d) not in self._quarantined and self.pool.is_alive(_slot(d))]
        cur = set(self.world.slots)
        fresh = [s for s in avail if s not in cur]
        if not fresh or len(avail) <= self.spec.n_devices:
            return
        back_to_full = set(avail) == self._full_ids
        if not back_to_full:
            # would the extra capacity be USED? a survivor count whose plan
            # is no wider than today's must not move the state for nothing
            plan, _ = elastic._plan_for_survivors(
                self.recipe, self._n_params, avail, self.config.batch_per_device,
                self.global_batch, self.planner_overrides, self.pool.device)
            if plan.spec.n_devices <= self.spec.n_devices:
                return
        t0 = time.perf_counter()
        width_before = self.spec.n_devices
        self._goodput.mark("grow", step=step, to=len(avail))
        kind = None
        redone = 0
        extra: dict = {}
        # replay grow-back only back onto the FULL topology: a partial fleet
        # cannot produce full-width bits — partial growth rides keep
        if self.config.growback == "replay" and not self._pure and back_to_full:
            # barrier BEFORE the lineage query: an in-flight pure save is
            # invisible to latest_step (it scans committed dirs) and would
            # then be pruned as "mixed" once it lands
            self.world.wait_saves()
            pure_step = self._ckpt.latest_step(where=lambda m: m.get("lineage") == "pure") or 0
            self._ckpt.delete_steps([s for s in self._ckpt.all_steps() if s > pure_step])
            self.world.leave()
            t1 = time.perf_counter()
            if pure_step == 0:
                # the deterministic init is the pure state at step 0
                world = self._form(self._full_slots, self._full_spec, self.seed)
                reasons = ("replay grow-back from the deterministic init "
                           "(no pure checkpoint survived the outage)",)
            else:
                world = self._form(self._full_slots, self._full_spec, None)
                extra["join_s"] = round(time.perf_counter() - t1, 6)
                t2 = time.perf_counter()
                world.restore(pure_step)
                extra["restore_s"] = round(time.perf_counter() - t2, 6)
                reasons = ("replay grow-back onto the original mesh",)
            state = elastic.ElasticState(world=world, spec=self._full_spec, reasons=reasons,
                                         step=pure_step)
            redone = (self._step - 1) - pure_step
            self._rewind(pure_step)
            self._adopt(state)
            self._pure = True
            kind = "grow_replay"
        if kind is None:
            # keep mode: live survivor-width state re-shards onto the
            # restored fleet — zero recompute, lineage stays mixed-width
            if back_to_full:
                state = elastic.reshard_onto(self.world, self._full_slots, self._full_spec,
                                             migrator=self.migrator,
                                             non_addressable=self.non_addressable)
            else:
                state = elastic.reconfigure(
                    self.world, avail, (), policy=self.policy,
                    batch_per_device=self.config.batch_per_device,
                    global_batch=self.global_batch, planner_overrides=self.planner_overrides,
                    migrator=self.migrator, non_addressable=self.non_addressable)
            extra.update({k: round(v, 6) for k, v in state.timings.items()})
            extra["plan"] = list(state.reasons)
            self._adopt(state)
            kind = "grow_keep"
        recovery_ms = (time.perf_counter() - t0) * 1e3
        self._finish_recovery(kind, recovery_ms, width_before, redone, fresh, extra=extra)


# ---------------------------------------------------------------------------
# Serving: decode-replica fleet with queue-depth autoscaling + chaos survival
# ---------------------------------------------------------------------------


class DecodeFleet:
    """Horizontal decode replicas behind one queue — the serving half of
    the chaos-survival story.

    ``make_replica()`` builds a ``serving.ContinuousBatcher`` (each replica
    owns its own slots/cache), or over a span of several pooled devices a
    ``serving.MeshDecodeWorker`` (a tensor-parallel replica, one rank
    process a device). Requests enter a fleet-level backlog and
    dispatch to the least-loaded replica each tick; autoscaling is
    QUEUE-DEPTH-DRIVEN:

    - scale UP: total waiting depth > ``scale_up_queue_depth`` × replicas
      and the fleet is below ``max_replicas``;
    - scale DOWN: a replica has been idle ``scale_down_idle_ticks``
      consecutive ticks and the fleet is above ``min_replicas``.

    :meth:`kill_replica` is the chaos hook: the dead replica's unfinished
    requests (queued, mid-admission, mid-decode; ``ContinuousBatcher.
    abandon``) re-enter the backlog and re-run from their prompts on the
    survivors — with greedy decoding the retried tokens are identical, so
    a replica loss costs latency, never tokens. Scale events land in
    ``serving_replica_scale_total{direction}`` /
    ``serving_replica_failures_total`` and the flight recorder."""

    def __init__(
        self,
        make_replica: Callable[[], object],
        min_replicas: int = 1,
        max_replicas: int = 4,
        scale_up_queue_depth: int = 4,
        scale_down_idle_ticks: int = 16,
        devices=None,
        devices_per_replica: int = 1,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas; got {min_replicas}, {max_replicas}")
        # device pool: with `devices` set, each replica SPANS
        # `devices_per_replica` devices — `make_replica(devices_tuple)`
        # builds it (serving.ContinuousBatcher.for_devices is the canonical
        # factory). A killed replica's devices return to the pool. Without
        # `devices`, `make_replica()` keeps the zero-arg contract.
        if devices_per_replica < 1:
            raise ValueError(f"devices_per_replica must be >= 1, got {devices_per_replica}")
        self._device_pool: list | None = list(devices) if devices is not None else None
        self.devices_per_replica = devices_per_replica
        if self._device_pool is not None:
            capacity = len(self._device_pool) // devices_per_replica
            if capacity < min_replicas:
                raise ValueError(
                    f"{len(self._device_pool)} pooled device(s) cannot back "
                    f"min_replicas={min_replicas} at {devices_per_replica} device(s) per replica")
            max_replicas = min(max_replicas, capacity)
        self._replica_devices: dict[int, tuple] = {}
        self._make = make_replica
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_up_queue_depth = scale_up_queue_depth
        self.scale_down_idle_ticks = scale_down_idle_ticks
        self._obs = get_registry()
        self._replicas: dict[int, object] = {}
        self._idle_ticks: dict[int, int] = {}
        self._next_replica = 0
        self._next_frid = 0
        self._backlog: deque[int] = deque()
        self._spec: dict[int, tuple] = {}       # frid -> (prompt, max_new)
        self._local: dict[tuple, int] = {}      # (replica, local rid) -> frid
        self._placed: dict[int, tuple] = {}     # frid -> (replica, local rid)
        self._results: dict[int, list] = {}
        self.scale_events: list[dict] = []
        for _ in range(min_replicas):
            self._spawn("initial")

    # ---- capacity --------------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def _spawn(self, reason: str) -> int:
        rid = self._next_replica
        self._next_replica += 1
        if self._device_pool is not None:
            if len(self._device_pool) < self.devices_per_replica:
                self._next_replica -= 1
                raise RuntimeError(
                    f"device pool exhausted: {len(self._device_pool)} free, "
                    f"{self.devices_per_replica} needed per replica")
            span = tuple(self._device_pool[: self.devices_per_replica])
            del self._device_pool[: self.devices_per_replica]
            self._replica_devices[rid] = span
            try:
                replica = self._replicas[rid] = self._make(span)
            except BaseException:
                # a failed factory returns its devices: nothing will ever
                # retire/kill this rid
                self._release_devices(rid)
                self._next_replica -= 1
                raise
        else:
            replica = self._replicas[rid] = self._make()
        # the replica id labels the batcher's serving metrics, so the
        # cluster aggregator sees per-replica series; ids are never reused
        if hasattr(replica, "obs_replica"):
            replica.obs_replica = str(rid)
        self._idle_ticks[rid] = 0
        self._note_scale("up", rid, reason)
        return rid

    def _release_devices(self, rid: int) -> None:
        span = self._replica_devices.pop(rid, None)
        if span is not None and self._device_pool is not None:
            self._device_pool.extend(span)

    def _retire(self, rid: int, reason: str) -> None:
        replica = self._replicas.pop(rid)
        close = getattr(replica, "close", None)
        if close is not None:  # a replica of rank processes (MeshDecodeWorker)
            close()
        self._idle_ticks.pop(rid, None)
        self._release_devices(rid)
        self._note_scale("down", rid, reason)

    def _note_scale(self, direction: str, rid: int, reason: str) -> None:
        self.scale_events.append({"direction": direction, "replica": rid, "reason": reason,
                                  "n_replicas": len(self._replicas)})
        if self._obs.enabled:
            self._obs.counter("serving_replica_scale_total", "decode replica scale events",
                              labels=("direction",)).inc(direction=direction)
            self._obs.gauge("serving_replicas", "live decode replicas").set(len(self._replicas))
            flight_recorder.record("serving_scale", direction=direction, replica=rid,
                                   reason=reason, n_replicas=len(self._replicas))

    def kill_replica(self, rid: int | None = None) -> int:
        """Chaos hook: drop a replica (default: the newest). Finished-but-
        uncollected results are harvested first; everything unfinished
        re-enters the backlog at the FRONT (it has waited longest). A
        replica of rank processes (``serving.MeshDecodeWorker``, the
        factory over a span of several devices) is killed: its processes
        end, its devices return to the pool."""
        if not self._replicas:
            raise RuntimeError("no replicas to kill")
        if rid is None:
            rid = max(self._replicas)
        replica = self._replicas.pop(rid)
        self._idle_ticks.pop(rid, None)
        self._release_devices(rid)
        self._harvest(rid, replica.collect())
        kill = getattr(replica, "kill", None)
        if kill is not None:
            # a replica of rank processes dies for real; what it held
            # unfinished is the fleet's own record of its requests
            kill()
            lrids = sorted(lrid for r, lrid in self._local if r == rid)
        else:
            lrids = [req.rid for req in replica.abandon()]
        requeued = 0
        for lrid in reversed(lrids):
            frid = self._local.pop((rid, lrid), None)
            if frid is None:
                continue
            self._placed.pop(frid, None)
            self._backlog.appendleft(frid)
            requeued += 1
        if self._obs.enabled:
            self._obs.counter("serving_replica_failures_total", "decode replicas lost").inc()
            self._obs.counter("serving_requeued_total",
                              "requests resubmitted after a replica loss").inc(requeued)
            self._obs.gauge("serving_replicas", "live decode replicas").set(len(self._replicas))
            flight_recorder.record("serving_replica_lost", replica=rid, requeued=requeued,
                                   n_replicas=len(self._replicas))
        self.scale_events.append({"direction": "down", "replica": rid, "reason": "killed",
                                  "n_replicas": len(self._replicas), "requeued": requeued})
        if not self._replicas and (self._backlog or self._placed):
            # zero capacity with work outstanding: re-arm the minimum fleet
            for _ in range(self.min_replicas):
                self._spawn("respawn_after_total_loss")
        return requeued

    # ---- requests --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        frid = self._next_frid
        self._next_frid += 1
        self._spec[frid] = (np.asarray(prompt, np.int32).reshape(-1), int(max_new_tokens))
        self._backlog.append(frid)
        return frid

    @property
    def outstanding(self) -> int:
        return len(self._backlog) + len(self._placed)

    def queue_depth(self) -> int:
        return len(self._backlog) + sum(b.n_queued for b in self._replicas.values())

    def _load(self, replica) -> int:
        return replica.n_queued + replica.n_active + replica.n_pending

    def _harvest(self, rid: int, collected: dict) -> None:
        for lrid, toks in collected.items():
            frid = self._local.pop((rid, lrid), None)
            if frid is not None:
                self._placed.pop(frid, None)
                # the prompt exists for requeue-on-failure only
                self._spec.pop(frid, None)
                self._results[frid] = toks

    def tick(self) -> None:
        """One fleet scheduler pass: dispatch → autoscale → step replicas →
        harvest."""
        from dsml_tpu_torch.serving import QueueFull

        # dispatch to the least-loaded replica with headroom; a replica at
        # its max_queue cap is excluded for THIS tick only
        capped: set = set()
        while self._backlog and self._replicas:
            open_replicas = [(r, b) for r, b in self._replicas.items() if r not in capped]
            if not open_replicas:
                break
            rid, replica = min(open_replicas, key=lambda kv: self._load(kv[1]))
            if self._load(replica) >= 2 * replica.n_slots:
                break  # the least-loaded is saturated → everyone open is
            frid = self._backlog.popleft()
            prompt, max_new = self._spec[frid]
            try:
                lrid = replica.submit(prompt, max_new)
            except QueueFull:
                self._backlog.appendleft(frid)
                capped.add(rid)
                continue
            self._local[(rid, lrid)] = frid
            self._placed[frid] = (rid, lrid)
        # queue-depth-driven scale-up (one replica per tick)
        if (len(self._replicas) < self.max_replicas
                and self.queue_depth() > self.scale_up_queue_depth * max(len(self._replicas), 1)):
            self._spawn("queue_depth")
        # drive every replica and harvest retirements
        for rid, replica in list(self._replicas.items()):
            busy = replica.n_active or replica.n_queued or replica.n_pending
            if busy:
                self._idle_ticks[rid] = 0
                replica.step()
                self._harvest(rid, replica.collect())
            else:
                self._idle_ticks[rid] += 1
        # idle scale-down (one per tick, never below the floor)
        if len(self._replicas) > self.min_replicas:
            idle = [r for r, t in self._idle_ticks.items() if t >= self.scale_down_idle_ticks]
            if idle:
                self._retire(max(idle), "idle")

    def run(self, max_ticks: int = 100_000) -> dict[int, list]:
        """Drain everything; returns {fleet rid: [tokens]}."""
        for _ in range(max_ticks):
            if not self.outstanding:
                break
            self.tick()
        else:
            raise RuntimeError(f"fleet did not drain within {max_ticks} ticks")
        out = dict(self._results)
        self._results.clear()
        return out
