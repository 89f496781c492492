#!/bin/bash
# Compares two trees of the repo on one card in one call: chip_smoke.py's
# phases `livo` and `bench` run on the parent, the change, the change and
# the parent again, in turns, so that both trees meet the same card, power
# limit and host.  Run from the root of the change's tree, with the
# parent unpacked into a directory of its own (`git archive`):
#
#     bash tests/torch_compare_trees.sh PARENT_DIR OUT_DIR
#
# The change's chip_smoke.py is copied into the parent tree first (its
# phases `livo` and `bench` also run on a tree from before the captured
# programs).  Each run's output goes to OUT_DIR/<phase>_<tree>_<turn>.log;
# the last lines of each are printed.
set -u
parent=$1
out=$2
mkdir -p "$out"
cp chip_smoke.py "$parent/chip_smoke.py"
turn=0
for tree in parent change change parent; do
    turn=$((turn + 1))
    if [ "$tree" = parent ]; then dir=$parent; else dir=.; fi
    for phase in livo bench; do
        log="$out/${phase}_${tree}_${turn}.log"
        (cd "$dir" && timeout 900 python3 chip_smoke.py --only "$phase") \
            > "$log" 2>&1
        echo "== $phase $tree $turn rc=$?"
        tail -c 3000 "$log"
    done
done
