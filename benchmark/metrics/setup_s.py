"""From the process's start to the first timed call: imports, the CUDA
context, the kernel library's build or load, the scenes, the pipelines and
models, the graphs' capture and the warm-up."""


def read(ctx):
    return ctx.setup_s
