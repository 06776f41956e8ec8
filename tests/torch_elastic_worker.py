"""Worker script for the PyTorch port's elastic-relaunch tests
(``tests/test_torch_launch.py``): the port's copy of
``tests/_elastic_worker.py``, over ``paddlebox_tpu_torch.elastic``.  It
imports neither torch nor JAX, so it starts and exits in a blink.

Simulates a pass-loop trainer: heartbeats through ElasticManager, makes
step progress against a SHARED job checkpoint (rank 0 persists it, every
generation resumes from it — the stand-in for io/checkpoint auto-resume),
and can fault-inject at step 3 of generation 0:

  kill         — rank 1 SIGKILLs itself once, in generation 0 (a
                 transient OOM kill -> the launcher must respawn it, not
                 scale in)
  kill_repeat  — rank 1 SIGKILLs itself in generations 0 AND 1 (repeat
                 SIGKILL from the same rank -> real node loss: scale-in)
  partition    — rank 1 stops heartbeating but stays alive (network
                 partition -> the launcher must SIGTERM it and scale in)
  skew         — rank 1 finishes a second after rank 0 (as a slow start
                 makes it): a healthy generation whose ranks exit apart

On completion each rank writes ``done-g{gen}-r{rank}`` so the test can
assert which generation/world finished the job.
"""

import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from paddlebox_tpu_torch.elastic import ElasticManager, FileStore  # noqa: E402

TOTAL_STEPS = 40


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "none"
    rank = int(os.environ["PBOX_RANK"])
    world = int(os.environ["PBOX_WORLD_SIZE"])
    gen = int(os.environ["PBOX_ELASTIC_GEN"])
    edir = os.environ["PBOX_ELASTIC_DIR"]

    store = FileStore(os.path.join(edir, "members"), ttl=6.0)
    em = ElasticManager(store, rank, world, heartbeat_interval=0.4)
    em.start()

    ckpt = os.path.join(edir, "job_ckpt.json")
    step = 0
    try:
        with open(ckpt) as f:
            step = int(json.load(f)["step"])
    except (FileNotFoundError, ValueError, KeyError):
        pass

    it = 0
    while step < TOTAL_STEPS:
        # fault-inject on the LOCAL iteration count: the shared checkpoint
        # advances while this rank is still importing, so a global-step
        # trigger could be skipped entirely on a slow-starting rank
        if rank == 1 and it == 3:
            kill_gens = {"kill": (0,), "kill_repeat": (0, 1)}.get(mode, ())
            if gen in kill_gens:
                os.kill(os.getpid(), signal.SIGKILL)
            if mode == "partition" and gen == 0:
                em.stop()               # heartbeat goes silent, process
                time.sleep(120)         # lingers until the launcher acts
        it += 1
        time.sleep(0.15)
        step += 1
        if rank == 0:                   # shared checkpoint, atomic write
            tmp = ckpt + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "gen": gen, "world": world}, f)
            os.replace(tmp, ckpt)

    if mode == "skew" and rank == 1:
        time.sleep(1.0)
    with open(os.path.join(edir, f"done-g{gen}-r{rank}"), "w") as f:
        f.write(str(step))
    em.stop()


if __name__ == "__main__":
    main()
