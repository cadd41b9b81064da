"""One host of the port's coordinated-restart test
(tests/test_torch_cluster.py).

Started by a ``resilience.cluster.ClusterSupervisor`` driver (through
``run_cluster_local``) with the ``DKT_CLUSTER_*`` environment: the host
starts its :class:`ClusterMember` (heartbeats, the collective watchdog),
joins the epoch's gloo group (``MASTER_PORT = base_port + epoch``),
and trains ADAG at ``num_workers=2`` on the CPU under a per-host
``Supervisor``, checkpointing every round into the shared directory.
With ``kill`` in the spec, host 1 of epoch 0 dies at that round
(``FaultPlan.kill``: no cleanup, exit 137).  On completion host 0 writes
the weights and the losses of the run it finished to ``<out>/final.npz``.
It imports neither jax nor ``distkeras_tpu``.

``python tests/torch_cluster_job.py spec.json``
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import distkeras_tpu_torch as dkt  # noqa: E402
from distkeras_tpu_torch.resilience import cluster  # noqa: E402
from distkeras_tpu_torch.resilience.chaos import FaultPlan  # noqa: E402


def main(spec_path):
    torch.set_num_threads(1)
    spec = json.load(open(spec_path))
    member = cluster.member_from_env()
    member.start()
    try:
        member.join_group(device="cpu", timeout=60)
        data = np.load(spec["data"])
        model = dkt.zoo.MLP(16, (32,), 4)
        dkt.module_from_keras_numpy(
            model, [data[f"w{i}"] for i in range(int(data["n_w"]))])
        t = dkt.ADAG(model, loss="sparse_categorical_crossentropy",
                     worker_optimizer="adam", learning_rate=0.01,
                     batch_size=8, num_epoch=3, communication_window=2,
                     num_workers=2, device="cpu",
                     checkpoint_dir=spec["ckpt"], checkpoint_every=1,
                     max_checkpoints=100)
        sup = dkt.Supervisor(t, max_retries=0, handle_sigterm=False)
        plan = FaultPlan()
        if spec.get("kill") and member.epoch == 0 and member.host == 1:
            plan.kill("train.round", at=spec["kill"])
        with plan:
            out = sup.run(dkt.Dataset.from_arrays(data["x"], data["y"]))
        member.complete()
        if member.host == 0:
            w = dkt.keras_numpy_from_module(out)[0]
            np.savez(os.path.join(spec["out"], "final.npz"),
                     history=np.asarray(t.history),
                     resumed_from=np.asarray(
                         sup.attempts[-1].resumed_from or 0),
                     **{f"w{i}": a for i, a in enumerate(w)})
        torch.distributed.destroy_process_group()
    finally:
        member.stop()


if __name__ == "__main__":
    main(sys.argv[1])
