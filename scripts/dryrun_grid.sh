#!/usr/bin/env bash
# The dry run's grid on both production meshes (16 x 16 and 2 x 16 x 16),
# one process a (cell, mesh), 8 at a time, slowest first (the one-card
# trace seconds of PERF.md section 6), then the report's tables:
#
#     bash scripts/dryrun_grid.sh [OUT_DIR]      # default results/dryrun_mesh
#
#     SHAPES=prefill_32k bash scripts/dryrun_grid.sh results/prefill_mesh
#
# SHAPES (all by default) keeps the cells of the shapes it names.
# Each process starts its own fake 256- or 512-rank process group
# (launch.dryrun --mesh single|multi); a cell that runs past CELL_LIMIT
# seconds (2,700 by default) is cut and recorded as failed ("error":
# "cut at ... s").  JOBS (8) processes run at once.  Prints one line a
# (cell, mesh) and the report's ok / skipped / failed counts;
# OUT_DIR/report.md holds the tables, OUT_DIR/log-*.txt each process's
# output.
set -u
export PYTHONPATH=src
OUT=${1:-results/dryrun_mesh}
mkdir -p $OUT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $OUT/card.txt
ORDER="xlstm_350m:prefill_32k xlstm_350m:train_4k hubert_xlarge:prefill_32k qwen2_vl_72b:prefill_32k deepseek_v2_236b:prefill_32k qwen2_5_3b:prefill_32k qwen3_14b:prefill_32k stablelm_3b:prefill_32k gemma2_27b:prefill_32k jamba_v01_52b:prefill_32k jamba_v01_52b:train_4k qwen2_vl_72b:train_4k mixtral_8x7b:prefill_32k hubert_xlarge:train_4k deepseek_v2_236b:train_4k gemma2_27b:train_4k mixtral_8x7b:train_4k stablelm_3b:train_4k qwen3_14b:train_4k qwen2_5_3b:train_4k"
ALL=$(python -c "import sys; sys.path.insert(0,'src'); from repro_torch import configs as C; print(' '.join(f'{a}:{s}' for a in C.ARCH_IDS for s in C.SHAPES))")
LIST=""
for c in $ORDER; do for m in single multi; do LIST="$LIST $c:$m"; done; done
for c in $ALL; do case " $ORDER " in *" $c "*) ;; *) for m in single multi; do LIST="$LIST $c:$m"; done;; esac; done
if [ -n "${SHAPES:-}" ]; then
  KEEP=""
  for c in $LIST; do
    for s in $SHAPES; do case "$c" in *":$s:"*) KEEP="$KEEP $c";; esac; done
  done
  LIST=$KEEP
fi
t0=$(date +%s)
# one line "arch shape mesh" a run; sh gets them as $0 $1 $2
LIMIT=${CELL_LIMIT:-2700}
echo $LIST | tr ' ' '\n' | grep . | tr ':' ' ' | xargs -P ${JOBS:-8} -L 1 sh -c '
  log="'$OUT'/log-$0-$1-$2.txt"
  timeout '$LIMIT' python -m repro_torch.launch.dryrun --arch $0 --shape $1 \
    --mesh $2 --out "'$OUT'" > "$log" 2>&1
  rc=$?
  if [ $rc -eq 124 ]; then
    printf "{\"arch\": \"%s\", \"shape\": \"%s\", \"mesh\": \"%s\", \"error\": \"cut at '$LIMIT' s\"}\n" \
      $0 $1 $2 > "'$OUT'/$0-$1-$2.json"
  fi
  echo "$0 $1 $2 rc=$rc $(grep -a "^\[" "$log" | tail -1 | cut -c1-300)"'
echo "grid wall $(( $(date +%s) - t0 )) s"
python -m repro_torch.launch.report $OUT > $OUT/report.md
head -3 $OUT/report.md
