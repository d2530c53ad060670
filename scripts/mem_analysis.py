"""Compiled-program memory breakdown of the detect pipeline at the
BASELINE sizes (memory_analysis(): temp + argument + output allocation
of the ONE jitted program — the apples-to-apples equivalent of the
reference's steady-state GPU footprint, readme.md:16, since both
preallocate everything).

Usage: python scripts/mem_analysis.py [WxH ...] [--num-features N]
"""

import argparse
import sys

sys.path.insert(0, ".")

from sift_jax.perf.cache import enable_compilation_cache

enable_compilation_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sizes", nargs="*",
                   default=["752x480", "1600x900", "1920x1200"])
    p.add_argument("--num-features", type=int, default=5000)
    args = p.parse_args(argv)

    import json

    import jax
    import jax.numpy as jnp

    from sift_jax.config import SiftConfig
    from sift_jax.core.types import build_plan
    from sift_jax.pipeline.detector import build_detect_fn

    for s in args.sizes:
        w, h = map(int, s.split("x"))
        cfg = SiftConfig(width=w, height=h,
                         num_features=args.num_features)
        fn = jax.jit(build_detect_fn(build_plan(cfg)))
        lowered = fn.lower(jnp.zeros((h, w), jnp.float32))
        m = lowered.compile().memory_analysis()
        mib = 1024.0 * 1024.0
        print(json.dumps({
            "metric": "memory", "size": s,
            "temp_mib": round(m.temp_size_in_bytes / mib, 1),
            "args_mib": round(m.argument_size_in_bytes / mib, 1),
            "output_mib": round(m.output_size_in_bytes / mib, 1),
            "total_mib": round((m.temp_size_in_bytes
                                + m.argument_size_in_bytes
                                + m.output_size_in_bytes) / mib, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
