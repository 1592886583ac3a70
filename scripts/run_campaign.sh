#!/bin/bash
# Sequential quality-campaign launcher (one accelerator process at a time)
# with a stall watchdog: a hung device call can leave the host blocked
# forever in jax.device_get (stack: flush_pending -> device_get ->
# array._value). No file activity in
# the run's workdir for STALL_S seconds => kill -9 and retry; the run
# resumes from its last full-state checkpoint (io.ckpt_every).
#
# Usage: bash scripts/run_campaign.sh [root] [run ...]
set -u
ROOT="${1:-runs/quality}"
shift 2>/dev/null || true
RUNS=("${@:-c3 pm pi bugstyle c4m}")
if [ "${#RUNS[@]}" -eq 1 ]; then RUNS=(${RUNS[0]}); fi
EPOCHS="${EPOCHS:-10}"
BPE="${BPE:-2500}"
# An in-process watchdog touches <workdir>/.heartbeat every few seconds
# while it considers the run healthy (incl. compile-bound phases that write
# nothing else — a cold padded-step compile blocks for minutes). It covers BOTH
# the training loop and the post-hoc eval phase (quality_campaign.py keeps
# one alive through eval), so this file-activity window only catches hard
# interpreter hangs.
STALL_S="${STALL_S:-900}"
TRIES="${TRIES:-3}"
mkdir -p "$ROOT"
LOG="$ROOT/campaign.log"

run_one() {
  local RUN=$1 attempt rc
  for attempt in $(seq 1 "$TRIES"); do
    echo "=== campaign run: $RUN attempt $attempt ($(date)) ===" | tee -a "$LOG"
    mkdir -p "$ROOT/$RUN"
    # heartbeat: a fresh run dir has no files yet (first writes come after
    # model init + compile), which would read as a "stall" at the
    # first check — give the window a starting timestamp
    touch "$ROOT/$RUN/.heartbeat"
    python scripts/quality_campaign.py --run "$RUN" --root "$ROOT" \
        --epochs "$EPOCHS" --batches-per-epoch "$BPE" >> "$LOG" 2>&1 &
    local PID=$!
    while kill -0 "$PID" 2>/dev/null; do
      sleep 60
      if ! kill -0 "$PID" 2>/dev/null; then break; fi
      local fresh
      fresh=$(find "$ROOT/$RUN" -type f -newermt "-${STALL_S} seconds" 2>/dev/null | head -1)
      if [ -z "$fresh" ]; then
        echo "--- $RUN stalled (no file activity ${STALL_S}s); killing $PID ($(date))" | tee -a "$LOG"
        kill -9 "$PID" 2>/dev/null
        break
      fi
    done
    wait "$PID"; rc=$?
    echo "=== $RUN attempt $attempt exit=$rc ($(date)) ===" | tee -a "$LOG"
    [ "$rc" -eq 0 ] && return 0
  done
  return 1
}

for RUN in "${RUNS[@]}"; do
  run_one "$RUN"
done
echo "campaign done ($(date))" | tee -a "$LOG"
