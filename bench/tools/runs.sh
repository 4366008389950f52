#!/bin/bash
# Run one cell several times in a row, a process a run, and keep each
# run's output under chiprun_out/<tag>/:
#   bash bench/tools/runs.sh <tag> <cell> <seconds> <trace> <control> <seed>...
set -u
tag=$1; cell=$2; secs=$3; trace=$4; control=$5; shift 5
out=chiprun_out/$tag
mkdir -p "$out"
for seed in "$@"; do
  t0=$(date +%s.%N)
  python3 bench/run.py --workload "$cell" --seed "$seed" --seconds "$secs" \
    --trace "$trace" --control "$control" \
    > "$out/$cell.$seed.t$trace.out" 2> "$out/$cell.$seed.t$trace.err"
  rc=$?
  t1=$(date +%s.%N)
  echo "$cell seed=$seed trace=$trace rc=$rc wall=$(awk "BEGIN{print $t1 - $t0}")"
  tail -n 3 "$out/$cell.$seed.t$trace.err"
  tail -n 1 "$out/$cell.$seed.t$trace.out" | cut -c1-1500
done
