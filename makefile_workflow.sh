#!/usr/bin/env bash
# The Makefile's SOL workflow on the PyTorch port, every command as the
# Makefile writes it with `python -u -m solver_in_the_loop_torch` in place of
# $(PY), each timed. The 100-epoch trainings are replaced by the repository's
# trained nets (artifacts/a3_k_sol32, artifacts/a3_b_sol04), copied to where
# the run_test targets read them. Then `evaluate` turns the rollouts into the
# accuracy metric, as results_full_workload/eval{,100}_sol32_re*.json and
# eval_burgers_sol04_seed10*.json hold it for the JAX package.
#
#     bash makefile_workflow.sh WORKDIR OUTDIR
#
# WORKDIR receives the scene sets (about 1.5 GB); OUTDIR receives
# workflow.jsonl (one line per command: its name and wall seconds), each
# command's log and each evaluate's JSON line. Runs on the CUDA card.
set -euo pipefail

REPO=$(cd "$(dirname "$0")" && pwd)
WORK=$(mkdir -p "$1" && cd "$1" && pwd)
OUT=$(mkdir -p "$2" && cd "$2" && pwd)
PY="python -u -m solver_in_the_loop_torch"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
cd "$WORK"

# timed NAME COMMAND...: run COMMAND, its output to OUT/NAME.log, and append
# {"step": NAME, "seconds": wall seconds} to OUT/workflow.jsonl
timed() {
    local name=$1
    shift
    local t0 t1
    t0=$(date +%s.%N)
    "$@" > "$OUT/$name.log" 2>&1
    t1=$(date +%s.%N)
    python3 -c "import json, sys; print(json.dumps({'step': sys.argv[1], 'seconds': float(sys.argv[3]) - float(sys.argv[2])}))" \
        "$name" "$t0" "$t1" >> "$OUT/workflow.jsonl"
}

# karman-2d: the training and test sets (Makefile karman-fdt-hires-set, -testset)
timed karman-fdt-hires-set $PY karman-gen -o karman-fdt-hires-set -r 128 -l 100 --seed 0 --thumb \
    --re 160000 320000 640000 1280000 2560000 5120000
timed karman-fdt-hires-testset $PY karman-gen -o karman-fdt-hires-testset -r 128 -l 100 --seed 0 \
    --thumb --re 240000 480000 960000 1920000 3840000

# karman-fdt-sol32/run_test with the trained SOL-32 net
mkdir -p karman-fdt-sol32/tf
cp "$REPO/artifacts/a3_k_sol32/model.msgpack" "$REPO/artifacts/a3_k_sol32/dataStats.json" \
    karman-fdt-sol32/tf/
# (the functions' variables are local: bash's locals are dynamically scoped,
# and `timed` keeps the step's name in one)
run_test_karman() {
    local i re
    for i in 0 1 2 3 4; do
        re=$(( 10000 * 2**(i+3) * 3 ))
        $PY karman-apply -o karman-fdt-sol32/run_test --stats karman-fdt-sol32/tf/dataStats.json \
            --model karman-fdt-sol32/tf/model.msgpack \
            --initdH karman-fdt-hires-testset/sim_00000$i/dens_001000.npz \
            --initvH karman-fdt-hires-testset/sim_00000$i/velo_001000.npz \
            -d 4 -r 32 -l 100 --re $re -t 500
    done
}
timed karman-fdt-sol32-run_test run_test_karman

# the accuracy metric at 100 and 499 steps per test Re
evaluate_karman() {
    local i re steps name
    for i in 0 1 2 3 4; do
        re=$(( 10000 * 2**(i+3) * 3 ))
        for steps in 100 499; do
            name=$([ "$steps" = 100 ] && echo eval100 || echo eval)
            $PY evaluate --run karman-fdt-sol32/run_test/sim_00000$i \
                --ref karman-fdt-hires-testset/sim_00000$i --ref-offset 1000 --scale 4 \
                --steps $steps | tail -n 1 > "$OUT/${name}_sol32_re$re.json"
        done
    done
}
timed karman-evaluate evaluate_karman

# burgers: the test set, burgers-fdt-sol04/run_test with the trained SOL-04
# net, and the metric over its 199 steps
run_testset_burgers() {
    local i
    for i in 100 101 102 103 104; do
        $PY burgers-gen -o burgers-fdt-hires-testset -r 128 -l 32 --dt 0.1 -s 30 -t 200 \
            --seed $i --thumb
    done
}
timed burgers-fdt-hires-testset run_testset_burgers
mkdir -p burgers-fdt-sol04/tf
cp "$REPO/artifacts/a3_b_sol04/model.msgpack" "$REPO/artifacts/a3_b_sol04/dataStats.json" \
    burgers-fdt-sol04/tf/
run_test_burgers() {
    local i sim
    for i in 0 1 2 3 4; do
        sim=$(printf '%06d' $i)
        $PY burgers-apply -o burgers-fdt-sol04/run_test --stats burgers-fdt-sol04/tf/dataStats.json \
            --model burgers-fdt-sol04/tf/model.msgpack \
            --initvH burgers-fdt-hires-testset/sim_$sim/velo_000000.npz \
            --loadfH "burgers-fdt-hires-testset/sim_$sim/forc_0*.npz" \
            -d 4 -r 32 -l 32 --dt 0.1 -t 200
    done
}
timed burgers-fdt-sol04-run_test run_test_burgers
evaluate_burgers() {
    local i
    for i in 0 1 2 3 4; do
        $PY evaluate --run burgers-fdt-sol04/run_test/sim_00000$i \
            --ref burgers-fdt-hires-testset/sim_00000$i --ref-offset 0 --scale 4 --steps 199 \
            --field velTf | tail -n 1 > "$OUT/eval_burgers_sol04_seed10$i.json"
    done
}
timed burgers-evaluate evaluate_burgers

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
