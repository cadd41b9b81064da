"""SLO-gated canary rollout of published weight versions.

The port's copy of ``distkeras_tpu/serving/canary.py``, the policy half
of the train -> serve loop (``serving/publish.py`` is the transport): a
:class:`CanaryController` pushes version N+1 to a canary subset of the
router's fleet, gates on a pinned-prompt logit-drift probe plus the
per-replica SLO state the router tracks (the ``degraded`` flag the
``breach_demoter`` sets), and then promotes the version fleet-wide or
rolls the canaries back to version N (``swap_params(old,
allow_downgrade=True)`` per canary).  Promote and rollback both commit
under a bumped router epoch (:meth:`Router.bump_epoch`).

The drift probe is ``max |logits_new - logits_old|`` in f32 over the
pinned prompt, each side one ``_decode_chunk(uniform_pos=True)`` over a
fresh ``init_cache(cfg, 1)`` on the template's device, NaN mapped to
+inf so a poisoned push always trips.  It never touches an engine's
serving state.

The engines swap IN PLACE (``swap_params`` copies into the live weight
tensors), so an engine's ``params`` is not a stable snapshot of its
incumbent version: before the first promotion the rollback source is a
copy of each canary's live tree, taken before its swap.

Locking: ``serving.canary`` is the OUTERMOST serving-plane lock — a
rollout takes it, then the router's lock, then each engine's admission
lock; never the reverse.
"""

from __future__ import annotations

import math

import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.parallel.tree import tree_leaves, tree_map
from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.serving.publish import SnapshotCorrupt
from distkeras_tpu_torch.utils.locks import TracedLock

__all__ = ["CanaryController"]


def _drift(params_new, params_old, rows, cfg, device) -> float:
    """Greedy logits of the candidate against the incumbent over fresh
    zero caches: the max-abs difference over every prompt position, in
    f32, with NaN mapped to +inf (a NaN anywhere means the candidate
    cannot be compared, which must TRIP the gate, not sneak past a ``>``
    that NaN always fails)."""
    from distkeras_tpu_torch.models.generate import _decode_chunk, init_cache

    pos = torch.zeros((1,), dtype=torch.long, device=device)
    with torch.no_grad():
        new_logits, _ = _decode_chunk(
            params_new, init_cache(cfg, 1, device=device), rows, pos, cfg,
            uniform_pos=True)
        old_logits, _ = _decode_chunk(
            params_old, init_cache(cfg, 1, device=device), rows, pos, cfg,
            uniform_pos=True)
        d = (new_logits.float() - old_logits.float()).abs().max()
    d = float(d)
    return math.inf if math.isnan(d) else d


def _copy_tree(tree):
    """A copy of a live tree, where it lives (the incumbent an in-place
    swap would otherwise overwrite)."""
    return tree_map(lambda t: t.detach().clone(), tree)


class CanaryController:
    """Push → gate → promote-or-rollback over a router's fleet.

    ``router``: the :class:`~distkeras_tpu_torch.serving.router.Router`
    whose in-process replicas wrap ``hot_swap=True`` engines.
    ``reader``: a :class:`~distkeras_tpu_torch.serving.publish.
    SnapshotReader` for :meth:`poll` (may be None when the caller
    feeds :meth:`rollout` directly).  ``cfg``/``template``: the model
    config and a param tree of tensors: snapshots load into its
    geometry and onto its device, where the drift probe runs.

    ``canary``: how many replicas take the push first.  ``max_drift``:
    the finite drift budget (default +inf: only a NaN/Inf candidate
    trips — set it when the deploy has a known logit tolerance).
    ``probe_prompt``: the pinned token prompt the probe scores.

    The SLO half of the gate is the router's own state: a canary whose
    ``degraded`` flag is set in the post-push fleet snapshot (the
    ``breach_demoter`` flips it when that replica's live SLO window
    breaches) fails the gate exactly like drift does.
    """

    def __init__(self, router, reader, cfg, template, *, canary: int = 1,
                 max_drift: float = float("inf"),
                 probe_prompt=(1, 2, 3)):
        if canary < 1:
            raise ValueError(f"canary must be >= 1, got {canary}")
        prompt = [int(t) for t in probe_prompt]
        if not prompt:
            raise ValueError("probe_prompt must carry >= 1 token")
        self.router = router
        self.reader = reader
        self.cfg = cfg
        self.template = template
        self.canary = int(canary)
        self.max_drift = float(max_drift)
        self._device = tree_leaves(template)[0].device
        self._rows = torch.tensor([prompt], dtype=torch.long,
                                  device=self._device)
        self._lock = TracedLock("serving.canary")
        # The last successfully promoted (version, tree) — the
        # rollback source once version 1 has been promoted; before
        # that, canaries roll back to each engine's own live tree.
        self._good: tuple | None = None
        # Versions a rollout rejected: :meth:`poll` quarantines them
        # so a gate-tripped publish is pushed ONCE, not re-pushed on
        # every tick until the trainer publishes something newer.
        self._rejected: set[int] = set()

    # ------------------------------------------------------------ gate

    def _drift(self, new_tree, old_tree) -> float:
        on_dev = lambda t: torch.as_tensor(t).to(self._device)  # noqa: E731
        drift = _drift(tree_map(on_dev, new_tree),
                       tree_map(on_dev, old_tree), self._rows, self.cfg,
                       self._device)
        obs.observe("canary.drift", drift)
        return drift

    # --------------------------------------------------------- rollout

    def rollout(self, version: int, tree) -> dict:
        """Run one full push of ``tree`` as ``version``: canary swap →
        drift + SLO gate → promote fleet-wide or roll the canaries
        back.  Returns the rollout record
        ``{"action", "version", "drift", "canaries", "promoted"}``.

        Atomic from the fleet's point of view: on ANY failure —
        gate trip, a mid-swap exception, a chaos fault at the
        ``canary.promote`` probe — every replica that saw version
        ``version`` is rolled back to what it served before, and the
        epoch is bumped so routing state never straddles the attempt.
        """
        version = int(version)
        with obs.held(self._lock):
            return self._rollout_locked(version, tree)

    def _rollout_locked(self, version: int, tree) -> dict:
        snap = self.router.fleet_snapshot()
        handles = self.router.replica_handles()
        eligible = sorted(
            n for n, r in snap["replicas"].items()
            if r["up"] and not r["draining"]
            and hasattr(handles[n], "swap_params"))
        if not eligible:
            raise ValueError(
                "no eligible replicas: a rollout needs >= 1 up, "
                "non-draining replica wrapping a hot_swap=True engine")
        canaries = eligible[:self.canary]
        rest = eligible[self.canary:]
        old = self._good[1] if self._good is not None else None
        obs.event("canary.push", version=version,
                  canaries=len(canaries), fleet=len(eligible))
        # ---- canary swap (stash each replica's incumbent for the
        # rollback path; reading it through the handle keeps version N
        # alive however this attempt ends).
        swapped: list = []
        try:
            for n in canaries:
                incumbent = (old if old is not None
                             else _copy_tree(handles[n].engine.params))
                from_v = handles[n].param_version()
                handles[n].swap_params(tree, version)
                swapped.append((n, incumbent, from_v))
            drift = self._drift(tree, swapped[0][1])
            post = self.router.fleet_snapshot()
            degraded = [n for n in canaries
                        if post["replicas"][n]["degraded"]
                        or not post["replicas"][n]["up"]]
            # Non-finite drift ALWAYS trips — ``inf <= inf`` would
            # otherwise wave a NaN push through the default budget.
            tripped = (not math.isfinite(drift)
                       or drift > self.max_drift or bool(degraded))
            if tripped:
                return self._rollback(
                    version, swapped, drift,
                    reason=("slo_degraded" if degraded
                            else "drift"))
            # ---- promote: the canaries passed; the rest of the
            # fleet follows, then the epoch commits the new version
            # set.  A fault injected at the probe site lands AFTER
            # the gate but BEFORE any non-canary swap — the rollback
            # below must leave the whole fleet on the incumbent.
            chaos.probe("canary.promote", step=version)
            for n in rest:
                handles[n].swap_params(tree, version)
        except Exception:
            self._rollback(version, swapped, None, reason="error")
            raise
        self.router.bump_epoch(f"canary promote v{version}")
        self._good = (version, tree)
        if self.reader is not None:
            self.reader.adopt(version)
        obs.count("canary.promotions")
        obs.event("canary.rollout", action="promote", version=version,
                  drift=drift, canaries=len(canaries),
                  promoted=len(eligible))
        return {"action": "promote", "version": version,
                "drift": drift, "canaries": list(canaries),
                "promoted": len(eligible)}

    def _rollback(self, version: int, swapped, drift,
                  reason: str) -> dict:
        for n, incumbent, from_v in swapped:
            # allow_downgrade: THE legitimate monotonicity exception.
            n_handle_swap_ok = True
            try:
                # Re-fetch nothing: the handle in ``swapped`` is the
                # one we pushed through; an engine that died between
                # push and rollback surfaces here, not silently.
                self.router.replica_handles()[n].swap_params(
                    incumbent, from_v, allow_downgrade=True)
            except Exception as e:  # noqa: BLE001 — best-effort per
                # replica: one dead canary must not strand the rest
                # on the rejected version.
                n_handle_swap_ok = False
                obs.event("canary.rollback_failed", replica=n,
                          error=f"{type(e).__name__}: {e}"[:200])
            if n_handle_swap_ok:
                obs.event("canary.replica_rollback", replica=n,
                          to_version=from_v)
        self._rejected.add(version)
        self.router.bump_epoch(
            f"canary rollback v{version} ({reason})")
        obs.count("canary.rollbacks")
        obs.event("canary.rollout", action="rollback", version=version,
                  drift=drift, reason=reason, canaries=len(swapped),
                  promoted=0)
        return {"action": "rollback", "version": version,
                "drift": drift, "reason": reason,
                "canaries": [n for n, _, _ in swapped], "promoted": 0}

    # ------------------------------------------------------------ poll

    def poll(self) -> dict | None:
        """One train→serve tick: surface the newest fully-verified
        snapshot strictly above the adopted version and roll it out.
        Returns the rollout record, an ``{"action": "abort"}`` record
        when the newest publish is torn/corrupt (engines keep serving
        the current version), or
        None when there is nothing new."""
        if self.reader is None:
            raise ValueError(
                "poll() needs a SnapshotReader (reader=); feed "
                "rollout() directly otherwise")
        latest = self.reader.latest_version()
        if latest is not None and int(latest) in self._rejected:
            return None
        try:
            nxt = self.reader.poll(self.template)
        except SnapshotCorrupt as e:
            obs.count("canary.aborts")
            obs.event("canary.abort", reason=f"{e}"[:200])
            return {"action": "abort", "error": str(e)}
        if nxt is None:
            return None
        version, tree = nxt
        return self.rollout(version, tree)
