#!/usr/bin/env bash
# Parent-against-change pairs of the benchmark on one card, in turns.
#
#   tools/ab_pairs.sh PARENT CHANGE OUT SECONDS TRACE CELL:SEED [CELL:SEED ...]
#
# PARENT and CHANGE are two checkouts of the repo (from `git archive`).
# Each CELL:SEED is one pair: `python3 -m portbench.run --workload CELL
# --seed SEED --seconds SECONDS --trace TRACE` run in PARENT and in
# CHANGE, parent first in the 1st, 3rd, ... pair and change first in the
# 2nd, 4th, ..., so that neither side always runs on a warmer card. Each
# run's output and errors go to OUT/{P,C}_CELL_SEED_tTRACE.{out,err}; one
# line a run (side, cell, seed, exit code, the result line) to stdout.
set -u
if (( $# < 6 )); then
  sed -n '2,12p' "$0" >&2
  exit 2
fi
parent=$1 change=$2 out=$3 seconds=$4 trace=$5
shift 5
mkdir -p "$out"
out=$(cd "$out" && pwd)
i=0
for pair in "$@"; do
  cell=${pair%%:*} seed=${pair##*:}
  if (( i % 2 )); then order="C P"; else order="P C"; fi
  for side in $order; do
    dir=$parent
    [[ $side == C ]] && dir=$change
    f="$out/${side}_${cell}_${seed}_t${trace}"
    (cd "$dir" && python3 -m portbench.run --workload "$cell" \
      --seed "$seed" --seconds "$seconds" --trace "$trace") \
      >"$f.out" 2>"$f.err"
    rc=$?
    echo "$side $cell $seed rc=$rc $(tail -n 1 "$f.out")"
  done
  i=$((i + 1))
done
