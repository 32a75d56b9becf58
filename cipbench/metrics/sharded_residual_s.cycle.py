"""Device seconds a cycle spends in this rank's sharded residual: the program's device span ``sharded.residual`` (its shards' predicts, slot residuals and inverts and the image psum)."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "cycle", span_seconds(["sharded.residual"],
                                               "device_s"))
