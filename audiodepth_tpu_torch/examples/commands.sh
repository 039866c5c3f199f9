#!/usr/bin/env bash
# Example experiment commands of the PyTorch/CUDA port: the reference's
# run_*.sh / example_commands.sh surface on the port's CLIs, with the JAX
# package's examples/commands.sh flags (plus --device cuda).
# All commands assume the repository root on PYTHONPATH.
set -e

DATA_V2=${DATA_V2:-/data/Batvision/BatvisionV2}
DATA_V1=${DATA_V1:-/data/Batvision/BatvisionV1}

# ---------------------------------------------------------------------------
# UNet baseline (reference: train.py / run_base_experiment.sh)
# paper settings: BV2 bs=256 lr=0.002; BV1 bs=128 lr=0.001
# (the port saves checkpoints only under --ckpt_dir: the evaluations below
# read this run's)
# ---------------------------------------------------------------------------
python -m audiodepth_tpu_torch.cli.train --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --model unet_baseline --batch_size 256 --learning_rate 0.002 \
    --criterion Combined --experiment_name paper_bv2 --device cuda --ckpt_dir ./checkpoints

python -m audiodepth_tpu_torch.cli.train --dataset batvisionv1 --dataset_dir "$DATA_V1" \
    --model unet_baseline --batch_size 128 --learning_rate 0.001 \
    --experiment_name paper_bv1 --device cuda

# sequence holdout (train.py:294-373)
python -m audiodepth_tpu_torch.cli.train --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --model unet_baseline --holdout_locations Hall Office --experiment_name holdout --device cuda

# ---------------------------------------------------------------------------
# cVAE UNet (reference: train_cvae.py)
# ---------------------------------------------------------------------------
python -m audiodepth_tpu_torch.cli.train --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --model unet_cvae --experiment_name cvae --device cuda

# ---------------------------------------------------------------------------
# Base + Residual (reference: train_base_residual.py / run_base_residual_examples.sh)
# adaptive 3-term loss + detach curriculum are defaults
# ---------------------------------------------------------------------------
python -m audiodepth_tpu_torch.cli.train --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --model base_residual --experiment_name base_residual --device cuda

# ---------------------------------------------------------------------------
# Binaural cross-attention (reference: train_binaural_attention.py)
# base_channels=64; cosine schedule + AdamW wd as in the script
# ---------------------------------------------------------------------------
python -m audiodepth_tpu_torch.cli.train --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --model binaural_attention --base_channels 64 --batch_size 64 \
    --lr_schedule cosine --experiment_name binaural --device cuda

# ---------------------------------------------------------------------------
# RGB teacher (reference: train_rgb_depth.py / run_rgb_depth_examples.sh)
# ---------------------------------------------------------------------------
python -m audiodepth_tpu_torch.cli.train --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --model rgb_depth --lr_schedule cosine --experiment_name rgb_teacher --device cuda

# ---------------------------------------------------------------------------
# AdaBins distillation (reference: train_adabins_distillation.py / run_adabins_examples.sh)
# ---------------------------------------------------------------------------
python -m audiodepth_tpu_torch.cli.train --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --model adabins_distillation --n_bins 128 --lr_schedule cosine \
    --experiment_name adabins --device cuda

# ---------------------------------------------------------------------------
# Coarse depth family (reference: train_coarse_depth.py; needs sparse targets)
# ---------------------------------------------------------------------------
python -m audiodepth_tpu_torch.tools.preprocess_sparse_depth \
    --dataset_dir "$DATA_V2" --method downup_015
python -m audiodepth_tpu_torch.cli.train --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --model coarse_depth --model_type hybrid --n_bins 8 --bin_strategy sid \
    --sparse_method downup_015 \
    --lr_schedule warm_restarts --experiment_name coarse_hybrid --device cuda

# ---------------------------------------------------------------------------
# Evaluation (reference: test.py) + export
# ---------------------------------------------------------------------------
python -m audiodepth_tpu_torch.cli.evaluate --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --experiment_name paper_bv2 --eval_on test --visualize --save_tensors --device cuda
# best-validation checkpoint via a direct path (experiment auto-extracted)
python -m audiodepth_tpu_torch.cli.evaluate --dataset batvisionv2 --dataset_dir "$DATA_V2" \
    --checkpoint_path ./checkpoints/paper_bv2 --use_best --eval_on val --device cuda
# the inference graph as a torch.export program (.pt2, not StableHLO)
python -m audiodepth_tpu_torch.tools.export --dataset batvisionv2 --model unet_baseline \
    --out ./export/unet_bv2.pt2 --device cuda

# ---------------------------------------------------------------------------
# Profiling: a torch.profiler trace of the first epoch after the first
# ---------------------------------------------------------------------------
python -m audiodepth_tpu_torch.cli.train --dataset synthetic --model binaural_attention \
    --epochs 3 --batch_size 64 --profile_dir /tmp/adepth_profile \
    --experiment_name profiled --device cuda
