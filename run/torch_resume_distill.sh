#!/bin/sh
# usage: sh run/torch_resume_distill.sh EXP_DIR CONFIG
#            [key value]... [--device cpu]
# The port's run/resume_distill.sh: experiment dir and a teed,
# timestamped log.
# Exits with the run's status, which fd 4 carries past tee.
set -e
exp_dir=$1; config=$2; shift 2
log="$exp_dir/resume-$(date +%Y%m%d_%H%M%S).log"
exec 3>&1
status=$( { { python -u -m openscene_tpu_torch.runtime.distill \
    --config="$config" save_path "$exp_dir" \
    resume "$exp_dir/model/model_last.ckpt" "$@" 2>&1 \
    && echo 0 >&4 || echo $? >&4; } | tee "$log" >&3; } 4>&1 )
exit "$status"
