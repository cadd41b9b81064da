"""Job deployment: describe and launch a data-parallel job's ranks.

Counterpart of ``distkeras_tpu/deploy.py`` (reference parity:
distkeras/job_deployment.py::Job).  The port runs one process per
device: the same script starts ``world`` times, each process with its
identity in the environment ``torch.distributed`` reads (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), and
calls :func:`init_from_env` once at the top to join the group.

:class:`Job` is the declarative spec: ``command_for(rank)`` renders one
rank's launch command (for an ssh fan-out over hosts, ``procs_per_host``
ranks per host), and ``run_local()`` starts every rank on this host and
waits for them.  ``init_method`` (e.g. ``file:///path/rdv``) replaces
the TCP rendezvous at ``coordinator`` (read by :func:`init_from_env`
from ``DKT_INIT_METHOD``).  No ssh client is embedded.

On the CPU: ``Job("train.py", world=4, init_method="file://...")
.run_local()`` and, in ``train.py``, ``init_from_env(device="cpu")``
(gloo).  On GPUs: one rank per card, ``init_from_env()`` (NCCL on
``cuda:LOCAL_RANK``).
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import subprocess
import sys
import tempfile
import time


@dataclasses.dataclass
class Job:
    """A data-parallel job: ``script`` runs once per rank."""

    script: str
    world: int = 1
    coordinator: str = "localhost:29500"
    init_method: str | None = None
    procs_per_host: int | None = None
    env: dict = dataclasses.field(default_factory=dict)
    args: tuple = ()
    # Remote hosts' interpreter — NOT sys.executable, whose path is only
    # meaningful on the machine rendering the commands.
    interpreter: str = "python3"

    def env_for(self, rank: int) -> dict:
        if not (0 <= rank < self.world):
            raise ValueError(f"rank {rank} outside 0..{self.world - 1}")
        per_host = self.procs_per_host or self.world
        addr, _, port = self.coordinator.rpartition(":")
        out = {**{k: str(v) for k, v in self.env.items()},
               "RANK": str(rank), "WORLD_SIZE": str(self.world),
               "LOCAL_RANK": str(rank % per_host),
               "MASTER_ADDR": addr or "localhost", "MASTER_PORT": port}
        if self.init_method is not None:
            out["DKT_INIT_METHOD"] = self.init_method
        return out

    def command_for(self, rank: int) -> str:
        """Shell command launching rank ``rank``."""
        env = " ".join(f"{k}={shlex.quote(v)}"
                       for k, v in sorted(self.env_for(rank).items()))
        argv = " ".join(shlex.quote(a) for a in
                        (self.script, *map(str, self.args)))
        return f"env {env} {shlex.quote(self.interpreter)} {argv}"

    def command_lines(self) -> list[str]:
        """One launch command per rank."""
        return [self.command_for(r) for r in range(self.world)]

    def run_local(self, check: bool = True, timeout: float | None = None,
                  capture: bool = False) -> list:
        """Start every rank on this host and wait for all of them.

        ``timeout``: seconds before every rank is killed and
        ``TimeoutError`` raised (None = wait forever).  A rank that
        exits nonzero stops the others and raises ``RuntimeError``
        naming it (``check=False`` returns the processes instead).
        ``capture=True`` keeps each rank's output (``.stdout`` /
        ``.stderr`` text on the returned ``CompletedProcess``es).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        procs, outs = [], []
        try:
            for r in range(self.world):
                out = (tempfile.TemporaryFile() if capture else None,
                       tempfile.TemporaryFile() if capture else None)
                outs.append(out)
                procs.append(subprocess.Popen(
                    [sys.executable, self.script, *map(str, self.args)],
                    env={**os.environ, **self.env_for(r)},
                    stdout=out[0], stderr=out[1]))
            failed = None
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad and check:
                    failed = bad[0]
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"job {self.script!r} did not finish within "
                        f"{timeout}s (ranks killed)")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        done = []
        for r, (p, (o, e)) in enumerate(zip(procs, outs)):
            text = []
            for f in (o, e):
                if f is None:
                    text.append(None)
                    continue
                f.seek(0)
                text.append(f.read().decode(errors="replace"))
                f.close()
            done.append(subprocess.CompletedProcess(
                p.args, p.returncode, text[0], text[1]))
        if check:
            bad = [r for r, c in enumerate(done) if c.returncode != 0]
            if bad:
                r = failed if failed is not None else bad[0]
                tail = (done[r].stderr or "")[-2000:]
                raise RuntimeError(
                    f"job {self.script!r} rank {r} exited with returncode "
                    f"{done[r].returncode}" + (f":\n{tail}" if tail else ""))
        return done


def init_from_env(device=None, backend: str | None = None,
                  timeout: float = 600.0):
    """Join the process group from the environment a :class:`Job` sets;
    returns this rank's device, or None (no-op) when no ``WORLD_SIZE``
    is set, so a script runs unchanged alone.  ``device``/``backend``:
    see ``parallel.mesh.initialize_multihost`` (the card by default;
    ``device="cpu"`` for gloo)."""
    from distkeras_tpu_torch.parallel.mesh import initialize_multihost

    if "WORLD_SIZE" not in os.environ:
        return None
    return initialize_multihost(
        init_method=os.environ.get("DKT_INIT_METHOD"), device=device,
        backend=backend, timeout=timeout)
