"""The control: the plain reference put in the program's place, computed
in 32-bit words instead of the 64-bit words ntHash2 states
(``nthash_ref``'s ``bits=32``). The check must call it not correct. Not
run by the benchmark's own runs; ``portbench/control.py`` runs it."""

from __future__ import annotations


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.ref = ctx.reference
        self.st = self.ref.zeros(ctx)

    def one_pass(self) -> None:
        self.ref.add_pass(self.ctx, self.st, bits=32)

    def state(self):
        return self.st

    def close(self) -> None:
        self.ref = None
