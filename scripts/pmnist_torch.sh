#!/usr/bin/env bash
# The Permuted-MNIST protocol on one card at seed 1 (the seed of the
# minted results/pmnist_r4), resumable across time-limited runs:
#
#   bash scripts/pmnist_torch.sh OUT        # from the repository's root
#
# Trains `python -m vargp_tpu_torch p_mnist --seed=1` into
# runs/pmnist_torch_s1 with --resume, for at most $RIDE_LIMIT seconds
# (default 2950); once ckpt9.npz exists, runs analyze_pmnist
# (--perm_seed=1) and compare_methods against the minted analysis.  The
# log goes to OUT/pmnist_s1.txt and the run directory is copied to
# OUT/pmnist_torch_s1; to go on from a cut run, copy that directory back
# to runs/pmnist_torch_s1 first.
set -u
OUT=${1:?usage: bash scripts/pmnist_torch.sh OUT}
mkdir -p "$OUT"
D=runs/pmnist_torch_s1
mkdir -p $D
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$OUT/pmnist_s1.txt"
start=$(date +%s)
timeout ${RIDE_LIMIT:-2950} python3 -m vargp_tpu_torch p_mnist --seed=1 --log_dir=$D --resume >> "$OUT/pmnist_s1.txt" 2>&1
echo "train rc=$? wall_s=$(( $(date +%s) - start ))" | tee -a "$OUT/pmnist_s1.txt"
if [ -f $D/ckpt9.npz ]; then
  s2=$(date +%s)
  python3 -m vargp_tpu_torch analyze_pmnist $D --perm_seed=1 >> "$OUT/pmnist_s1.txt" 2>&1
  python3 -m vargp_tpu_torch compare_methods $D/analysis_torch.json \
    "--baselines={'minted_jax': 'results/pmnist_r4/analysis.json'}" \
    --out_json=$D/compare_minted.json >> "$OUT/pmnist_s1.txt" 2>&1
  echo "analysis rc=$? wall_s=$(( $(date +%s) - s2 ))" | tee -a "$OUT/pmnist_s1.txt"
fi
rm -rf "$OUT/pmnist_torch_s1"; cp -r $D "$OUT/pmnist_torch_s1"
