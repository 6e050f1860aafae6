"""Rank hooks for the process-grid tests (no tests of their own).

A rank hook travels to every worker of a grid by reference, so it lives
in a module the workers import cheaply: this one imports nothing but the
standard library."""
import contextlib


@contextlib.contextmanager
def fail_on_rank_3(rank):
    """A rank hook that makes rank 3 fail as its session starts."""
    if rank == 3:
        raise RuntimeError("rank 3 was told to fail")
    yield {"rank": rank}


@contextlib.contextmanager
def report_rank(rank):
    """A rank hook whose report names its rank."""
    yield {"rank": rank}
