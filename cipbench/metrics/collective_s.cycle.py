"""Device seconds a cycle spends in the image psum on this rank's card: the program's span ``collective.all_reduce`` (``parallel/mesh.py``; ``work_sharded.psum_seconds``), the wait for the last rank to arrive included."""
from cipbench.readers import per_call
from cipbench.work_sharded import psum_seconds


def read(run):
    return per_call(run, "cycle", psum_seconds())
