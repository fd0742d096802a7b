#!/bin/sh
# usage: sh run/torch_eval_mink.sh EXP_DIR CONFIG [key value]... [--device cpu]
# The port's run/eval_mink.sh: experiment dir and a teed, timestamped log.
# Exits with the run's status, which fd 4 carries past tee.
set -e
exp_dir=$1; config=$2; shift 2
mkdir -p "$exp_dir"
log="$exp_dir/eval-$(date +%Y%m%d_%H%M%S).log"
exec 3>&1
status=$( { { python -u -m openscene_tpu_torch.runtime.eval_seg \
    --config="$config" save_folder "$exp_dir/result_eval" "$@" 2>&1 \
    && echo 0 >&4 || echo $? >&4; } | tee "$log" >&3; } 4>&1 )
exit "$status"
