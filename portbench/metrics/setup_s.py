"""Set-up: process start to the first timed pass, on the host clock: the
CUDA start, the reads made from the seed (and the FASTQ written), every
kernel built and the warm-up pass."""


def read(ctx):
    return ctx.setup_s
