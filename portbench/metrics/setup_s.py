"""setup_s: process start to the window's first yield, less the dataset's
build: import torch, the CUDA context, the native and kernel libraries
from their caches, one warm region through the same entry."""


def read(ctx):
    return ctx.setup_s
