"""Profiling harness for the flagship pipeline (SURVEY.md §5).

Three views of where the time goes:

1. ``jax.profiler`` trace of one pipeline execution (view with
   TensorBoard / Perfetto; on a GPU the trace carries the device's kernel
   timeline beside the host-side events).
2. XLA cost analysis of the compiled program: total flops, bytes
   accessed, and the resulting bandwidth-roofline estimate.
3. An HLO "pass census": every entry-computation op touching large
   buffers, i.e. the list of memory passes the program actually makes
   (see ops/stacked_fft.py docstring).

Usage:  python scripts/profile_trace.py [trace_dir]
"""

import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp


def pass_census(compiled, min_gb=0.2):
    """(size_gb, op_kind, shape, fusion_kind) for big entry-computation ops."""
    out = []
    lines = compiled.as_text().splitlines()
    inentry = False
    for line in lines:
        if re.match(r"ENTRY ", line):
            inentry = True
            continue
        if inentry:
            if line.strip() == "}":
                break
            m = re.match(r"\s*%?[\w.-]+ = (\S+)\[([\d,]*)\]", line)
            if not m:
                continue
            shp = [int(s) for s in m.group(2).split(",") if s]
            size = int(np.prod(shp)) * 4 if shp else 0
            if size < min_gb * 1e9:
                continue
            rhs = line.split("=", 1)[1]
            km = re.search(r"\]\S*\s+(\w+)\(", rhs)
            fk = re.search(r"kind=(\w+)", line)
            out.append((size / 1e9, km.group(1) if km else "?",
                        m.group(2), fk.group(1) if fk else ""))
    return out


def main():
    import xrft_tpu
    from xrft_tpu import LabeledArray

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trace_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        root, "traces")

    B, N = 8, 4096
    rng = np.random.RandomState(0)
    da = LabeledArray(
        rng.randn(B, N, N).astype(np.float32),
        dims=("time", "y", "x"),
        coords={"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5},
    )

    def pipe(d):
        return xrft_tpu.power_spectrum(
            d, dim=["y", "x"], window="hann", detrend="linear").data

    print(f"backend: {jax.default_backend()}")
    f = jax.jit(pipe)
    compiled = f.lower(da).compile()

    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    flops = ca.get("flops", 0.0)
    bts = ca.get("bytes accessed", 0.0)
    print(f"cost analysis: {flops/1e9:.1f} GFLOP, {bts/1e9:.2f} GB accessed"
          f" -> {bts/819e9*1e3:.1f} ms at the 819 GB/s HBM bound")

    print("\npass census (ops touching > 0.2 GB):")
    for gb, kind, shape, fk in pass_census(compiled):
        print(f"  {gb:5.2f} GB  {kind:12s} {fk:8s} [{shape}]")

    # warm up, then capture one traced execution
    out = f(da)
    float(jnp.sum(out))
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        out = f(da)
        float(jnp.sum(out))
        wall = (time.perf_counter() - t0) * 1e3
    print(f"\ntraced execution: {wall:.1f} ms wall (incl. dispatch RPC)")
    print(f"trace written to {trace_dir} (tensorboard --logdir {trace_dir})")


if __name__ == "__main__":
    main()
