import os
import sys

# tests run on ONE device (the dry-run sets its own 512-device flag in a
# subprocess); make sure src/ is importable without installation.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    # CI splits tier1 into a matrix over the engines/policies:
    #   -m "not shard_map and not async_engine and not compression and
    #       not overlap"
    #                       -> everything single-device (simulated split)
    #   -m shard_map        -> the subprocess suites that force a device
    #                          grid (shard_map split)
    #   -m async_engine     -> the bounded-staleness engine's subprocess
    #                          suites (async split)
    #   -m compression      -> the compressed-reduction subprocess suites
    #                          (compression split)
    #   -m overlap          -> the communication-overlap engine's
    #                          subprocess suites (overlap split)
    config.addinivalue_line(
        "markers",
        "shard_map: exercises the shard_map engine in a subprocess with a "
        "forced multi-device grid (CI runs these in their own matrix leg)")
    config.addinivalue_line(
        "markers",
        "async_engine: exercises the bounded-staleness async engine in a "
        "subprocess with a forced multi-device grid (own CI matrix leg)")
    config.addinivalue_line(
        "markers",
        "compression: exercises compressed reductions on the mesh engines "
        "in a subprocess with a forced multi-device grid (own CI matrix "
        "leg)")
    config.addinivalue_line(
        "markers",
        "obs: telemetry-subsystem integration tests that run real solves "
        "under a tracer/registry (own CI matrix leg; the pure tracer/"
        "registry unit tests stay in the simulated split)")
    config.addinivalue_line(
        "markers",
        "overlap: exercises the communication-overlap engine in a "
        "subprocess with a forced multi-device grid (own CI matrix leg)")
    config.addinivalue_line(
        "markers",
        "online: online-service integration tests that run real "
        "warm-started incremental solves (own CI matrix leg; the pure "
        "queue/store/snapshot unit tests stay in the simulated split)")
    config.addinivalue_line(
        "markers",
        "card: needs a CUDA card (a kernel with no CPU path); the test "
        "decides inside itself and skips without one")
    config.addinivalue_line(
        "markers",
        "fleet: multi-tenant batched-solve integration tests that run "
        "real fleet-vs-solo equivalence solves (own CI matrix leg; the "
        "pure packing/bucketing unit tests stay in the simulated split)")
