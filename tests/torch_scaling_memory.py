"""Peak device memory of a tree's phase `scaling`, for comparing two trees
of the repo on one card (a tree from before phase `scaling` printed its
own peaks included).  On the GPU machine, from the root of any checkout:

    python3 tests/torch_scaling_memory.py TREE_DIR

It imports TREE_DIR's `chip_smoke.py` and package, builds the plane
kernel, runs `scaling_phase()` in this process and prints, as the last
line, one JSON object with the peak allocated and reserved bytes of the
caching allocator over the phase.  Imports torch and the tree only.
"""
import json
import os
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from sr_livo_tpu_torch import kernels
    kernels.build("plane_fit")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    chip_smoke.scaling_phase()
    print(json.dumps({"tree": tree, "scaling_memory": {
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_reserved_bytes": torch.cuda.max_memory_reserved()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
