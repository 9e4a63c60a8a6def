"""Pre-build SS + J̄ artifacts for the BASELINE configs.

`model_hash` canonicalizes grids through f32, so artifacts solved on one
backend are hit by runs on another (utils/checkpoint.py). Artifacts go to
the artifact root ($HANK_TPU_CACHE, else `.hank_cache/` in the checkout).

    PYTHONPATH=. python scripts/build_artifacts.py [configs...]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from measure_configs import build  # noqa: E402


def main(names):
    from hank_tpu.utils.checkpoint import get_or_solve

    for name in names:
        model, _ = build(name)
        t0 = time.perf_counter()
        ss0, ssT, Jbar = get_or_solve(model)
        print(json.dumps({
            "config": name,
            "setup_seconds": round(time.perf_counter() - t0, 1),
            "jbar_shape": list(Jbar.shape),
        }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["ks_T300", "ks_T200", "hank1_T300", "kslg_T150",
                          "hank2_T300"])
