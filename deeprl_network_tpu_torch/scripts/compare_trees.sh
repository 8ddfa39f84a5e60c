#!/usr/bin/env bash
# Compare two trees of this repository on one card, in turns: profile_step at
# the flagship levers once each, then five fresh processes of the bench twin
# each in the order O T T O O T T O O T (O the other tree, T this one), so that
# host drift between the first and last minutes falls on both sides alike.
#
#   bash deeprl_network_tpu_torch/scripts/compare_trees.sh OTHER_TREE OUT_DIR
#
# OTHER_TREE is an unpacked tree of another commit (for example
# `git archive <commit> | tar -x -C _checkout/parent`, a directory .gitignore
# lists). Each process's stdout and stderr go to OUT_DIR/<label>.{out,err}; a
# line per process (exit code, wall seconds, its last line) goes to stdout.
# Both trees' kernels are built first, so no timed process builds them.
set -u
other=$(cd "$1" && pwd)
root=$(cd "$(dirname "$0")/../.." && pwd)
out=$(mkdir -p "$2" && cd "$2" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
run() {  # tree label command...
  local tree=$1 label=$2
  shift 2
  local dir=$root
  [ "$tree" = other ] && dir=$other
  local t0 t1 rc
  t0=$(date +%s.%N)
  (cd "$dir" && "$@") > "$out/$label.out" 2> "$out/$label.err"
  rc=$?
  t1=$(date +%s.%N)
  echo "$label rc=$rc wall=$(python -c "print(round($t1 - $t0, 1))") $(tail -n 1 "$out/$label.out")"
}
for tree in other this; do
  run $tree build_$tree python -c \
    "from deeprl_network_tpu_torch.ops import _build; print(_build.build())"
done
flagship="--num-envs 768 --dtype bfloat16 --sparse-comm --remat"
run other profile_other python -m deeprl_network_tpu_torch.scripts.profile_step $flagship
run this profile_this python -m deeprl_network_tpu_torch.scripts.profile_step $flagship
i=0
for tree in other this this other other this this other other this; do
  i=$((i + 1))
  run $tree bench_${i}_$tree python -m deeprl_network_tpu_torch.bench
done
grep -H "kernels a call" "$out"/profile_*.err
