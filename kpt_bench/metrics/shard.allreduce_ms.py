"""shard.allreduce_ms (ms a step): device time of the NCCL all-reduce kernels
(events whose name starts with `ncclDevKernel_AllReduce` or
`ncclKernel_AllReduce`) on the traced rank, rank 0, over the steps traced:
parallel/shard.train_step_tiled's one all-reduce of the loss and the scene
gradients a step (parallel/mesh.all_reduce_sum). The kernel starts when
this rank reaches it and ends when the slowest rank has, so beyond the
transfer of a few KB it is this rank's wait for the slowest. Moves
shard_step_ms in inverse10_rows4.step1080."""

MATCH = ("ncclDevKernel_AllReduce", "ncclKernel_AllReduce")


def read(ctx):
    if not ctx.traced.kernel_count(lambda name: name.startswith(MATCH)):
        return None
    return ctx.traced.kernel_seconds(lambda name: name.startswith(MATCH)) * 1e3 / ctx.steps
