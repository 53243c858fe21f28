"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (needs one CUDA card)
    python3 chip_smoke.py --ddp-child SPEC   # one rank of phase_ddp
    (phase_mp's processes run launch_torch.py, instrumented by mp_child)

Phases (any failure exits non-zero; nothing is caught):
  1. environment: torch / CUDA / nvcc versions and the card's name and power
     limit (``nvidia-smi``); exits 1 without a CUDA card.
  2. build: compiles every kernel under sceneverse_tpu_torch/csrc with nvcc
     for sm_90a, one nvcc per source, all started together (cached in
     build/kernels/).
  2b. preprocess (``phase_preprocess``): the offline tools. One raw scan
     per processor written from a seed at its release's scale (PREPROCESS_SCANS:
     3RScan 200,000 vertices with a 200,000-vertex label mesh, MultiScan
     300,000 vertices and 600,000 faces, ARKitScenes 1,000,000 vertices,
     Structured3D 400,000 points; 3RScan with a 1024 x 1024 texture), each
     processor run with ``device="cuda"`` and ``device="cpu"`` from one seed
     (3RScan's CPU run searches with the JAX package's ``cKDTree`` query in
     place of the brute force): instance ids, labels, align angles and
     split files equal, vertices and colours within PREPROCESS_TOL, every
     ``.pth`` numpy on the host; ``generate_ssg`` on each card-processed
     tree on both devices, its JSON files byte-equal; the card's
     nearest-vertex search against ``cKDTree`` (index differences must be
     exact ties); no port kernel launched. Prints each processor's device
     pass and whole time on each device.
  2c. tools (``phase_tools``): the port's five measuring tools, each in
     its own process at a small setting, all at once (TOOL_RUNS: latency at
     batch 1 and 8, towers at batch 8, the pipeline tool for 2 steps on a
     1-scan fixture, the scale drill at 200 scans and 3 steps, caplen on
     the fixture): every expected line parses, names this card (name,
     power limit, NVIDIA driver, CUDA and torch versions) and holds finite
     positive values; the latency and towers tools' model and the
     pipeline tool's trainer launch ``fps``, ``sa_group_mlp_pool`` and
     ``mha_fwd`` (and ``mha_bwd``); the pipeline tool times the copy from
     pageable and pinned memory; meanwhile this process rebuilds the
     latency tool's model from its seed into a trainer (``mode=test``, bf16)
     whose ``forward`` argmax at batch 8 must equal the tool's.
  3. kernels: each hand-written kernel against its plain PyTorch twin on the
     card at the GPS pretrain shapes (f32 and bf16 where the path has both),
     with CUDA-event times of kernel, twin and, where one PyTorch call
     computes the same function, that call (``library_ms``: SDPA forward and
     backward for the MHA kernels; timed here, never called by the port),
     and the least time the card could take (``bound_ms``). The four
     ``sa_train`` kernels run at SA1, SA2 and SA3 of the fused slice and
     must give bit-identical outputs twice; so must ``sa_group_mlp_pool``
     (SA1, SA2) and ``sa_dense_pool`` (SA2: equal to the former bit for
     bit), on the path's input, with empty balls and with every point in
     every ball, each row with its in-ball pair share; ``fps`` (SA1, SA2)
     and ``ball_group`` (SA1, exact and fast, with and without empty balls)
     equal to their twins bit for bit and over two runs, each row also with
     the kernel's device time alone (``device_ms``: torch.profiler, without
     the wrapper's host time) and ``fps`` with its instruction floor
     (computed, so only in ``chip_smoke_kernels.json``'s ``per_shape``);
     ``flash_fwd`` / ``flash_bwd`` (L = 50, 300, 130, with and
     without the bias ``ab``; SDPA as their library yardstick; each row
     with its ``device_ms``, both backward launches together; and both at
     L = 300 with whole trailing key tiles of pad and an all-pad row, whose
     skipped tiles must change no bit) and
     ``mha_fwd`` / ``mha_bwd`` (the four GPS attention shapes and the
     grounding variants' two cross-attention shapes, 80 queries over 50
     keys and 50 over 80; their f32 bound counts the products at the
     3xTF32 tensor-core rate).
  4. slices: ``run_torch.main`` on ``synthetic_pretrain`` at full GPS width
     (768-d, 80 objects x 1024 points, 50 + 300 tokens, batch 32): train
     steps, val and test eval, with the frozen PointNet++, unfrozen
     (``model.vision.args.freeze=False``: trainable PointNet++, train-mode
     BatchNorm), unfrozen with ``SCENEVERSE_BN_FOLD=on`` and
     ``SCENEVERSE_SA_TRAIN_FUSED=on`` set for that slice only (every SA
     level through the fused ``sa_train`` kernels), and frozen in the JAX
     package's exact mode (``EXACT_ENV``: no fused MHA, flash attention in
     eval, the batched SA2 stage, the full caption tower: the parity
     recipe of PARITY_KIT.md). Launch counters are reset just before
     each and read just after; every kernel of each path must have
     launched, the fused slice's ``sa_*`` kernels exactly as often per
     train step as three fused levels need, the exact slice's kernels
     exactly as often per forward and per eval batch as its path needs
     (``check_exact_launches``); the unfrozen runs must move every
     PointNet++ weight and BatchNorm statistic. The slices run at
     ``solver.log_every=1``: each step's losses are fetched from the card
     before the next step starts, so a row's ``step_s`` (host clock from
     the step's start to the end of that fetch) is a synchronised time.
  5. entry: ``run_torch.main`` with ``mode=test pretrain_ckpt_path=`` the
     exact slice's ``best.pth`` loads every tensor and reproduces that
     slice's test metrics.
  6. trainer (``phase_trainer``), on the frozen f32 slice at full width
     with dropout on: one train step with no remat, ``model.remat=true``
     under "full" and under "dots" (bit-equal losses, gradients within
     REMAT_TOL, equal generator states, the recompute's ``mha_fwd``
     launches, a lower peak under "full"); gradient accumulation over 4
     micro-steps at k = 2 (parameters still between updates, two updates,
     the LR schedule over total // 2, the first update equal to one taken
     by hand); VERDICT #2's ``OpenVocabTrainer`` run, 32 steps, cut after
     epoch 4 and resumed by a fresh trainer from ``ckpt_4.pth`` (the
     resumed state bit-equal to the saved one, a falling loss, a rising
     train accuracy; launch counts set to 0 before and read after); and
     the ``profile.enabled``, ``debug.nans`` and ``eval.save`` switches,
     ``profile.enabled`` also at ``solver.steps_per_dispatch=2`` over an
     eager chunk, the capturing chunk and a replay (``profile_k2``: the
     trace's ``mha_fwd``, ``mha_bwd``, ``fps`` and ``sv_sa_fwd_kernel``
     events equal to the launches counted in those steps, as the
     ``TraceWindow`` that ``utils/profiling.py::trace`` yields counts them;
     an incomplete window is traced again by the trainer).
  6b. graphs (``phase_graphs``): the JAX trainer's dispatch paths as CUDA
     graphs, frozen and unfrozen_fused at full width (f32, dropout on) and
     frozen at k = 2 / K = 3: GRAPH_BATCHES eager steps against the same
     batches through ``train_forward_backward_k`` from one saved state
     (parameters and logged rows within GRAPH_TOL), two replays on one
     chunk drawing other masks, each step's CUDA-event ms eager and
     graphed, the peak at K = 1 and K, one H2D copy a chunk, and the fused
     val split with a tail batch equal to the eager loop; then
     ``model.remat=true`` under "full" and "dots" at K = 3 (``graph_remat``:
     eager against graphed bit for bit, the recompute's ``mha_fwd``
     launches as ``remat_extra_fwd`` counts them, two replays drawing other
     masks, the graphed peak under "full" below the no-remat graphed
     peak, the remat tape's bytes, each step's CUDA-event ms).
  7. data (``phase_data``): ``configs/final/all_pretrain.yaml`` as it
     stands (batch 64, 4 spawned train-loader workers, the five families'
     datasets and wrappers; the one-batch val and test loaders in this
     process, ``eval_loaders_in_process``) through
     ``run_torch.main`` from an on-disk
     SceneVerse tree the port's ``data/fixture.py`` writes under build/
     (1 scan, 90 objects of 1200 points, about 2,500 train items), only the
     data roots, ``num_gpu=1``, ``data.args.pc_type=gt``, one epoch and a
     fetch per step set: every loss finite, ``fps``, ``sa_group_mlp_pool``,
     ``mha_fwd`` and ``mha_bwd`` launched exactly as often per train step
     and per eval batch as the frozen path needs and nothing else, val and
     test metrics in [0, 1], and on the val split every metric 1 when
     oracle logits replace the model's (``check_eval``, which also logs
     what the trained model picks); the same, for MATERIALIZED_STEPS
     train steps, with ``data.args.materialized=fast`` over stores built
     beforehand and its val and test loaders at 0 workers; ``mha_fwd`` / ``mha_bwd`` (f32 tolerance, two runs
     bit-equal) on the operands one train step on a pipeline batch hands
     them (B = 64: its text and object padding, its 'cond' gate);
     ``fps`` (bit-equal) and ``sa_group_mlp_pool`` (SA_TOL) against their
     twins at SA1 and SA2 on that batch (64 x 80 objects, pad objects of
     all 1.0 included) and, for comparison, on standard-normal objects,
     each with its in-ball pair share and device time; the train loader's
     scenes/s alone at 0 and 4 workers and materialized; one train step's
     device time on that batch against both runs' steps (busy share).
  8. finetune (``phase_finetune``): the four ``configs/final/finetune``
     configs ScanRefer (``GroundHeadV1``, batch 256), ScanQA
     (``QAHeadV1`` over 8,864 answers, the ScanQA BCE branch of
     ``TextObjWithinBatch``, batch 32), Nr3D (batch 256) and SQA3D (706
     answers, batch 32) through ``run_torch.main`` as they stand, from the
     ``best.pth`` the data phase's all_pretrain run saved, on a tree of 5
     scans x 120 objects x 1200 points the fixture writer makes with the
     phase's own QA files; only the data root, ``num_gpu=1``,
     ``data.args.pc_type=gt``, one epoch, a fetch per step, the checkpoint
     and ``dataloader.num_workers=0`` (FT_REDUCED) set, the train loader
     cut to its first FT_STEPS batches: the checkpoint's
     towers all loaded (``pretrain_head.*`` left over, the new head
     missing), every loss finite and moving, ``fps``,
     ``sa_group_mlp_pool``, ``mha_fwd`` and ``mha_bwd`` launched exactly as
     often per train step and per eval batch as the path needs, val and
     test metrics in [0, 1] with the config's target metric, and on the val
     split no og3d argmax on a pad object and every metric 1 on oracle
     outputs (``check_finetune_eval``); on the ScanRefer run's first train
     batch (256 x 80 objects) ``fps`` (bit-equal) and ``sa_group_mlp_pool``
     (SA_TOL) at SA1 and SA2, and ``mha_*`` on one train step's operands
     at B = 256; that step's device time and busy share.
  9. objcls (``phase_objcls``): the four ``sa_train`` kernels at ObjCls's
     SA3 (259 -> 256, 512, 512 over 40,960 rows: a width no GPS path has)
     against their twins, bit-stable, with times and bounds; ``ObjCls``
     (``ObjPretrainTrainer``, ``PretrainObjEval``, ``SyntheticObjDataset``)
     through ``run_torch.main`` at full width (OBJCLS_CFG: 32 scenes x 80
     objects x 1024 points, clip width, 607 classes, AdamW) for 2 epochs of
     4 steps with val and test, on the literal route and again with the
     two fused-SA gates set for that run only: every loss finite,
     ``ball_group`` once and ``fps`` twice per train step and per eval
     batch and, fused, the ``sa_*`` kernels 6 / 6 / 3 / 3 per train step,
     nothing else; every PointNet++ weight and BatchNorm statistic moved;
     accuracy in [0, 1]; each route's train step's device time and peak
     memory; the val pass on oracle logits scoring 1; ``mode=test
     pretrain_ckpt_path=`` its ``best.pth`` loading every tensor and giving
     the test accuracy of that state; open vocabulary with Adam and
     warmup_exp, closed with SGD (momentum 0.9), and ScanNetPretrainObj
     from a 32-scan fixture tree at batch 16, an epoch each, with the same
     checks; then ``OpenVocabPerScene`` at the SLICE_ARGS width on 8 scenes
     x 4 sentences (``phase_perscene``): og3d logits (8, 4, 80), one
     ``mha_fwd`` per attention layer, its outputs equal to ``OpenVocab``'s
     on the 32 rows with each scene's objects repeated, and a train-mode
     backward of ``lm_cls_loss`` that launches ``mha_bwd``.
 10. variants (``phase_variants``): ``OpenVocab`` at the SLICE_ARGS width
     through ``build_trainer`` with ``model.grounding`` set to
     ``EntitySpatialCrossEncoder`` and to ``UnifiedSpatialCrossEncoderV1``
     (768 wide, 12 heads, 4 layers, 'center'), 3 train steps (forward,
     losses, backward, AdamW) and 2 eval batches each, and with
     ``model.language`` set to ``CLIPLanguageEncoder`` at
     clip-vit-large-patch14's text width (12 layers, random weights, frozen;
     no scene caption, all_noscene's losses), 2 steps and 1 batch: losses
     finite and moving, og3d logits finite, ``mha_fwd`` / ``mha_bwd`` /
     ``fps`` / ``sa_group_mlp_pool`` launched exactly as often as the
     config's fused attention layers and SA levels need
     (``variant_attn_per_forward``) and nothing else, the train steps'
     peak memory and one more step's device time; the entity encoder once
     more with 'vertical_bottom' pairwise locations. Then the PointNet++
     variant library: VoteNet's backbone (4 ``PointnetSAModuleVotes``, 2
     ``PointnetFPModule``, 8 x 20,000 points), PointNet++'s MSG
     classification SA1 (``PointnetSAModuleMSG``, 16 x 1024 points), the
     same as ``PointnetSAModuleMSGVotes``, and ``PointnetLFPModuleMSG``
     back onto the 1024 points, each on the card against the same module
     on the CPU: FPS, ball-query and 3-NN indices equal, f32 values within
     TOL["f32"], f64 values and input gradients within PNET_TOL, with each
     module's f32 forward + backward time on the card.
 11. data parallel (``phase_ddp``): the card is one device and NCCL
     refuses two ranks on one device, so ``run_torch.main`` runs the frozen
     slice (3 steps, val and test over 97 items), the unfrozen_fused
     slice (2 steps) and the ObjCls run (2 steps, literal route), at one
     step a dispatch, and the frozen slice at ``solver.steps_per_dispatch``
     DDP_K = 2 (7 steps: three chunks through ``train_forward_backward_k``
     and a tail step; the world of 1 captures the second chunk's graph and
     replays it for the third, the gloo ranks run each chunk's steps in a
     row), in child processes of this script (``--ddp-child``):
     a world of 1 over NCCL at batch 32, then a world of 2 over gloo, both
     ranks on cuda:0, at 16 a rank (gloo reduces CUDA tensors through host
     memory); every dropout at 0. The two worlds' per-step losses, step-1
     summed gradient, step-1 and final BatchNorm statistics, final
     parameters and eval metrics against each other (``DDP_TOL``), every
     rank's state bit-equal to rank 0's, every kernel of each path
     launched on each rank (the fused ``sa_*`` exactly as often a step as
     three fused levels need, ObjCls's kernels exactly as often a step and
     an eval batch as its route needs), launches and host-clock step times
     per rank.
 11b. the dp x mp grid (``phase_mp``): worlds started through
     ``launch_torch.py`` as a user starts them, every process
     instrumented by ``mp_child`` (a ``sitecustomize`` on the children's
     path): a world of 1 in its python mode, then (a) dp 1 x mp 2 and (b)
     dp 2 x mp 2 in its spmd mode (``torch.distributed.run``), gloo on
     cuda:0, the frozen slice at SLICE_ARGS widths with the 30522-way
     text head split over mp (2 steps, val and test over 64 items, dropout
     off): losses, the step-1 clipped gradients with the head gathered,
     the parameters after AdamW and the eval metrics against the world of
     1 (``DDP_TOL["frozen"]``); every replicated parameter bit-equal on
     every rank, each rank's head rows bit-equal to its columns of the
     gathered head; the mp peers' summed gradients before the replicas'
     broadcast within MP_PEER_TOL; every frozen-path kernel launched on
     every rank; (b)'s ``best.pth`` resumed by a world of 1 with equal
     tensors; (b) again with dropout on for 1 step (mp peers' streams
     equal, dp ranks' apart). Prints each rank's host-clock steps and the
     CUDA-event times of the head's all-gather, its input's gradient sum,
     the clip's all-reduce, the replicas' broadcast and the dp gradient
     sum, with the card's name and power limit.
 12. prints the launches of ``fps`` traced in 8 profiler windows
     (``profiler_windows``: the empty windows that ``device_ms`` and
     ``kernel_sum_ms`` trace again), each phase's seconds and the total
     (``[time]``), the kernel table as one JSON line, the card line, and
     last ``{"ok": true, "device": {...}}``.

The device-time breakdown of the same slices is ``profile_torch.py``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

SLICE_ARGS = [
    "--config-path", os.path.join(REPO, "configs", "final"),
    "--config-name", "synthetic_pretrain",
    "data.args.max_obj_len=80", "data.args.num_points=1024",
    "data.args.max_seq_len=50", "data.args.max_scene_cap_len=300",
    "model.lm_max_predictions=16", "model.split_scene_cap_tower=True",
    "dataloader.batchsize=32", "data.synthetic_size=128", "solver.epochs=1",
]

# kernel-vs-plain tolerances, on max|kernel - plain| / max|plain|:
#  f32: both sides do the same f32 arithmetic in another summation order
#  bf16: probabilities / activations round to bf16 (step 2^-8 = 3.9e-3); an
#        element on a rounding boundary may land one step apart
TOL = {"f32": 1e-4, "bf16": 2e-2}
# SA: bf16 weights and activations on both sides (see ops/sa_forward.py)
SA_TOL = 1e-2
# ball_group: both modes gather, round and subtract like the twin: equal
# bit for bit (fast mode rounds the gathered values to bf16 on both sides)
BG_TOL = {"exact": 0.0, "fast": 0.0}
# sa_train kernels vs their twins, on max|kernel - plain| / max|plain|:
#  sums: sums and Gram over up to 2.6 M rows: f32 sums in another order,
#        and an occasional one-step bf16 flip of a single h value
#  grads: dW, da, db. Random cotangents cancel in these sums, so max|plain|
#        is ~sqrt(rows) times one row's term, while a ReLU decision that
#        lands the other way (u summed in another order) moves one row's
#        term whole: at SA2's 40960 pooled centers that is ~5e-3
#  pooled: a flipped bf16 h2 value moves the h3 of its row by one step of
#        a product term
#  rows / rows_max: per-row dx, see check_rows
#  arg_share: argmax entries that may differ from the twin's (near-ties, see
#        check_argmax); measured at most 1.8e-5 (SA3, ns=16) on an H100
SA_TRAIN_TOL = {"sums": 1e-3, "grads": 1e-2, "pooled": 1e-2, "rows": 1e-2,
                "rows_max": 0.25, "arg_share": 5e-5}
# each slice: (overrides, kernels of its path, environment for the slice
# only); the fused slice's sa_* kernels launch this often per train step
# (sa_stats twice per SA level, sa_pool once, each backward as often; eval
# runs BatchNorm on its running statistics, the literal route)
FUSED_ENV = {"SCENEVERSE_BN_FOLD": "on", "SCENEVERSE_SA_TRAIN_FUSED": "on"}
SA_TRAIN_PER_STEP = {"sa_stats": 6, "sa_stats_bwd": 6, "sa_pool": 3,
                     "sa_pool_bwd": 3}
# the JAX package's exact mode for evaluating checkpoints: no fused MHA,
# flash attention where dropout is inactive (eval), the batched SA2 stage,
# and the full caption tower (``SCENEVERSE_CAP_CLS_ONLY=off``, the parity
# recipe of PARITY_KIT.md:19-28). flash_fwd runs once per non-spatial
# attention layer of an eval batch: utterance BERT 4 + caption BERT 4 +
# unified encoder 4; the spatial 'cond' layers take the plain path
EXACT_ENV = {"SCENEVERSE_FUSED_MHA": "off", "SCENEVERSE_FLASH_ATTN": "on",
             "SCENEVERSE_SA2_BATCHED": "on", "SCENEVERSE_CAP_CLS_ONLY": "off"}
FLASH_PER_EVAL_BATCH = 12
PATHS = {
    "frozen": ([], ("fps", "sa_group_mlp_pool", "mha_fwd", "mha_bwd"), {}),
    "unfrozen": (["model.vision.args.freeze=False"],
                 ("fps", "ball_group", "mha_fwd", "mha_bwd"), {}),
    "unfrozen_fused": (["model.vision.args.freeze=False"],
                       ("fps", "ball_group", "mha_fwd", "mha_bwd",
                        *SA_TRAIN_PER_STEP), FUSED_ENV),
    "frozen_exact": ([], ("fps", "sa_group_mlp_pool", "sa_dense_pool",
                          "flash_fwd"), EXACT_ENV),
}
# H100 SXM: HBM bytes/s and peak FLOP/s by operand type (CUDA-core f32,
# dense bf16 tensor cores), from the H100 SXM datasheet; "3xtf32": f32-exact
# products on the tensor cores as three TF32 products at 495 TFLOP/s (the
# f32 rows of the mha kernels, which form them so)
HBM_RATE = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "3xtf32": 495e12 / 3}

SOURCES = {
    "fps": ("sceneverse_tpu_torch/csrc/sa_kernels.cu",
            "sceneverse_tpu/ops/pallas/sa_forward.py:229"),
    "ball_group": ("sceneverse_tpu_torch/csrc/sample_group.cu",
                   "sceneverse_tpu/ops/pallas/sample_group.py:39"),
    "sa_group_mlp_pool": ("sceneverse_tpu_torch/csrc/sa_kernels.cu",
                          "sceneverse_tpu/ops/pallas/sa_forward.py:353"),
    "mha_fwd": ("sceneverse_tpu_torch/csrc/mha_kernels.cu",
                "sceneverse_tpu/ops/pallas/mha.py:181"),
    "mha_bwd": ("sceneverse_tpu_torch/csrc/mha_kernels.cu",
                "sceneverse_tpu/ops/pallas/mha.py:229"),
    "sa_stats": ("sceneverse_tpu_torch/csrc/sa_train.cu",
                 "sceneverse_tpu/ops/pallas/sa_train.py:103"),
    "sa_stats_bwd": ("sceneverse_tpu_torch/csrc/sa_train.cu",
                     "sceneverse_tpu/ops/pallas/sa_train.py:184"),
    "sa_pool": ("sceneverse_tpu_torch/csrc/sa_train.cu",
                "sceneverse_tpu/ops/pallas/sa_train.py:210"),
    "sa_pool_bwd": ("sceneverse_tpu_torch/csrc/sa_train.cu",
                    "sceneverse_tpu/ops/pallas/sa_train.py:232"),
    "sa_dense_pool": ("sceneverse_tpu_torch/csrc/sa_kernels.cu",
                      "sceneverse_tpu/ops/pallas/sa_forward.py:98"),
    # the library's flash-attention kernels (forward; through its custom
    # VJP the dk/dv and dq backward kernels), called here in the repo
    "flash_fwd": ("sceneverse_tpu_torch/csrc/flash_attn.cu",
                  "sceneverse_tpu/ops/pallas/attention.py:105"),
    "flash_bwd": ("sceneverse_tpu_torch/csrc/flash_attn.cu",
                  "sceneverse_tpu/ops/pallas/attention.py:105"),
}


def log(*a):
    print(*a, flush=True)


def phase_env():
    import torch

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        log("[env] torch.cuda.is_available() is False: this smoke test runs "
            "only on a CUDA card")
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    from sceneverse_tpu_torch.ops import _build

    nv = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                        text=True).stdout.strip().splitlines()
    log(f"[env] nvcc: {nv[-1] if nv else '?'}")
    log(f"[env] card: {card}  device_count={torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from sceneverse_tpu_torch.ops import _build

    t0 = time.time()
    names = _build.build_all()
    dt = time.time() - t0
    log(f"[build] {names} built for sm_90a in {dt:.1f} s "
        f"({_build.NVCC_FLAGS})")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for n, txt in _build.LAST_BUILD_LOG.items():
            f.write(f"== {n}\n{txt}\n")
    for n, txt in _build.LAST_BUILD_LOG.items():
        for line in txt.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {n}: {line.strip()}")
    return dt


def cuda_ms(fn, reps=5):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


PROFILER_WINDOWS = 16  # traced windows a measurement may take


def _traced(fn, calls):
    """The device events of ``calls`` calls of ``fn`` in one torch.profiler
    window, which opens and closes with 50 ms of host sleep."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, *kernels, reps=5):
    """Median device duration (torch.profiler) of one call of ``fn``: the
    launches of the kernels whose names hold one of ``kernels``, summed per
    call, over the last ``reps`` of ``reps + 2`` traced calls after a
    warm-up: the kernels alone, without the wrapper's host time that a
    single call's CUDA events include. A window can trace fewer launches
    than were made: late in the process, after the trainer's CUDA graphs
    have run, every other window traces none (``profiler_windows``; cause
    not known), and a window once traced 6 of 7. Such a window measures
    nothing and is traced again, up to PROFILER_WINDOWS windows."""
    import torch

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_WINDOWS):
        events = _traced(fn, reps + 2)
        per_kernel = []
        for kernel in kernels:
            traced = sorted((e.time_range.start,
                             e.time_range.elapsed_us() / 1e3)
                            for e in events if kernel in e.name)
            if len(traced) > reps + 2:
                raise AssertionError(f"device_ms: {len(traced)} launches of "
                                     f"{kernel} traced in {reps + 2} calls")
            per_kernel.append([d for _, d in traced[-reps:]])
        counts = [len(d) for d in per_kernel]
        if min(counts) == reps:
            return statistics.median(sum(call) for call in zip(*per_kernel))
        log(f"[device_ms] traced {counts} launches of {kernels} in "
            f"{reps + 2} calls (window {attempt + 1} of {PROFILER_WINDOWS})")
    raise AssertionError(f"device_ms: fewer than {reps} launches of "
                         f"{kernels} traced in {PROFILER_WINDOWS} windows")


def profiler_windows(n=8, reps=5):
    """Launches of ``fps`` traced in each of ``n`` profiler windows of
    ``reps`` calls: the windows that trace none (``device_ms``)."""
    import torch

    from sceneverse_tpu_torch.ops import sa_forward as sa

    g = torch.Generator(device="cpu").manual_seed(0)
    xyz = (torch.rand((32 * 80, 1024, 3), generator=g) - 0.5).cuda()

    def fn():
        return sa.fps(xyz, 32)

    fn()
    counts = [sum("sv_fps_kernel" in e.name for e in _traced(fn, reps))
              for _ in range(n)]
    log(f"[profiler] launches of fps traced in {n} windows of {reps} calls "
        f"each: {counts}")
    return counts


def _err(got, want):
    """(max|got - want|, max|want|)."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def bound(nbytes, flops, dtype):
    """(least ms the card could take, which of the two binds): each input
    read once and each output written once at HBM rate, against the
    operations at the peak rate of their type."""
    t_bytes = nbytes / HBM_RATE * 1e3
    t_ops = flops / PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def key_bytes(valid, L, *per_key):
    """Bytes of attention operands indexed (batch, ..., key) -- k, v (B, H,
    L, dh) and ab (B, H, L, L) -- that a key-pad mask leaves needed: each
    batch row's valid keys, and all L of a row with none (its output is the
    mean of v). ``valid`` (B,) counts each row's valid prefix."""
    import torch

    keys = int(torch.where(valid > 0, valid, L).sum())
    return sum(nbytes(t) // (t.shape[0] * L) * keys for t in per_key
               if t is not None)


class Table:
    def __init__(self):
        self.rows = {}

    def add(self, name, shape, dtype, err, scale, ms, plain_ms, tol, bnd,
            library_ms=None, **extra):
        """One timed row; ``extra`` (e.g. an input's in-ball share) is
        logged and kept beside the row, apart from its shape key."""
        rel = err / max(scale, 1e-30)
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        more = "".join(f" {k}={v:.4f}" for k, v in extra.items())
        log(f"[kernel] {name:18s} {shape:34s} {dtype:9s} max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} (tol {tol:g}, max|plain| {scale:.3g}) "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}){more}")
        if not (rel <= tol and math.isfinite(rel) and scale > 0):
            raise AssertionError(f"{name} {shape} {dtype}: rel err {rel} > {tol}")
        r = self.rows.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append({"shape": shape, "dtype": dtype, "max_abs_err": err,
                            "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bnd[0], "bound_by": bnd[1],
                            "library_ms": library_ms, **extra})


def ball_counts(xyz, centers, radius):
    """(G, m) in-ball point counts, strict d2 < r^2 as the kernels test."""
    import torch

    from sceneverse_tpu_torch.ops.pointops import _sq3

    d = xyz[:, None, :, :] - centers[:, :, None, :]
    d2 = _sq3(d[..., 0], d[..., 1], d[..., 2])
    return (d2 < torch.tensor(radius * radius, dtype=torch.float32)).sum(-1)


def sa_pairs(xyz, centers, radius, ns):
    """(pairs, points) of the SA function on this input: the (center,
    point) pairs it pools -- each center's first min(ns, N) in-ball points
    (strict d2 < r^2) in index order, point 0 for an empty ball -- and the
    distinct points those pairs use."""
    import torch

    from sceneverse_tpu_torch.ops.pointops import _sq3

    d = xyz[:, None, :, :] - centers[:, :, None, :]
    within = _sq3(d[..., 0], d[..., 1], d[..., 2]) < torch.tensor(
        radius * radius, dtype=torch.float32)
    del d
    take = within & (within.cumsum(-1) <= ns)
    take[..., 0] |= ~within.any(-1)
    return int(take.sum()), int(take.any(1).sum())


def fps_bound(G, N, m):
    # read xyz, write centers + indices; per step and point: 3 sub, 3 mul,
    # 2 add of the distance (the min and the argmax are not counted)
    return bound(G * N * 12 + G * m * 16, 8 * (m - 1) * G * N, "f32")


def fps_instr_floor(G, N, m):
    """ms of the ~10 f32 instructions per point and step that ``fps``
    issues (the 8 of the bound, none an FMA, plus the min and the compare)
    at one instruction per lane and clock: half the f32 peak, which counts
    an FMA as two operations."""
    return 10 * (m - 1) * G * N / (PEAK["f32"] / 2) * 1e3


def phase_sa(table):
    import torch

    from sceneverse_tpu_torch.ops import sa_forward as sa

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    G = 32 * 80
    levels = [  # (N, C, npoint, nsample, radius, widths)
        (1024, 6, 32, 32, 0.2, [6, 64, 64, 128]),
        (32, 131, 16, 32, 0.4, [131, 128, 128, 256]),
    ]
    pts = torch.rand((G, 1024, 6), generator=g) - 0.5  # unit-cube objects
    pts[:, -64:, :3] = 0.0  # near-origin pad points
    pts = pts.to(dev)
    for li, (N, C, m, ns, r, spec) in enumerate(levels):
        tag = f"SA{li + 1} G={G} N={N} C={C} m={m}"
        xyz = pts[..., :3].contiguous()
        got_xyz, got_idx = sa.fps(xyz, m)
        want_xyz, want_idx = sa.fps_plain(xyz, m)
        mism = int((got_idx != want_idx).sum())
        if mism:
            raise AssertionError(f"fps {tag}: {mism} indices differ")
        if not (torch.equal(got_xyz, want_xyz)
                and torch.equal(sa.fps(xyz, m)[1], got_idx)):
            raise AssertionError(f"fps {tag}: centers differ from the twin "
                                 "or between two runs")
        table.add("fps", tag, "f32", *_err(got_xyz, want_xyz),
                  cuda_ms(lambda: sa.fps(xyz, m)),
                  cuda_ms(lambda: sa.fps_plain(xyz, m)), 0.0,
                  fps_bound(G, N, m),
                  device_ms=device_ms(lambda: sa.fps(xyz, m), "sv_fps_kernel"),
                  instr_floor_ms=fps_instr_floor(G, N, m))
        ws = []
        for cin, h in zip(spec[:-1], spec[1:]):
            ws.append(torch.randn((h, cin), generator=g) / math.sqrt(cin))
            ws.append(torch.stack([torch.rand(h, generator=g) + 0.5,
                                   torch.randn(h, generator=g) * 0.1], 1))
        ops = sa.prepare_weights(*[w.to(dev) for w in ws])
        centers = got_xyz.clone()
        centers[:8] += 5.0  # objects whose balls are all empty
        # (label, centers, radius): the path's input, empty balls, and every
        # point in every ball (the most rows the compaction can leave)
        for label, ctr, rad in (("", got_xyz, r), (" +empty", centers, r),
                                (" +all-in", got_xyz, 16.0)):
            entries = [("sa_group_mlp_pool", sa.sa_group_mlp_pool,
                        sa.sa_group_mlp_pool_plain, {"nsample": ns})]
            if ns >= N:  # SA2: the dense stage of the SA2_BATCHED route
                entries.append(("sa_dense_pool", sa.sa_dense_pool,
                                sa.sa_dense_pool_plain, {}))
            outs = [check_sa_fwd(table, name, tag + label, fn, plain, pts,
                                 ctr, ops, rad, ns, spec, kw)
                    for name, fn, plain, kw in entries]
            if len(outs) == 2 and not torch.equal(*outs):
                raise AssertionError(f"sa_dense_pool {tag}{label}: not the "
                                     "dense branch of sa_group_mlp_pool")
            if not label:
                got = outs[0]
        # next level consumes this level's output, as PointNetPP does
        pts = torch.cat([got_xyz, got], -1).contiguous()


def check_sa_fwd(table, name, tag, fn, plain, pts, ctr, ops, r, ns, spec,
                 kw):
    """One SA entry twice (bit-identical) and against its twin, with its
    input's in-ball pair share. Bound, bf16 operands: layer 1's product
    once per point a pair uses and its centering term once per center,
    layers 2-3 once per pair (``sa_pairs``: in-ball pairs, an empty ball
    once on point 0); each input read once and ``pooled`` written once.
    Returns the output."""
    import torch

    G, N, _ = pts.shape
    m = ctr.shape[1]
    got = fn(pts, ctr, *ops, radius=r, **kw)
    if not torch.equal(got, fn(pts, ctr, *ops, radius=r, **kw)):
        raise AssertionError(f"{name} {tag}: two runs differ")
    want = plain(pts, ctr, *ops, radius=r, **kw)
    pairs, points = sa_pairs(pts[..., :3], ctr, r, ns)
    c, h1, h2, h3 = spec
    flops = 2 * (points * c * h1 + G * m * 3 * h1 + pairs * (h1 * h2 + h2 * h3))
    table.add(name, tag, "f32", *_err(got, want),
              cuda_ms(lambda: fn(pts, ctr, *ops, radius=r, **kw)),
              cuda_ms(lambda: plain(pts, ctr, *ops, radius=r, **kw), reps=3),
              SA_TOL, bound(nbytes(pts, ctr, want, *ops), flops, "bf16"),
              in_ball=pairs / (G * m * min(ns, N)))
    del want
    torch.cuda.empty_cache()
    return got


def phase_flash(table):
    """``flash_fwd`` and ``flash_bwd`` against their twins at the GPS
    lengths (B=32, H=12, dh=64; L 50 utterance, 300 caption, 130 unified)
    with a key-pad mask, with and without the additive bias ``ab``, and a
    random cotangent. Library yardstick: SDPA with the same boolean key
    mask (a float mask, ab with -inf at pads, where ab is given), bf16, its
    backward through autograd; timed only."""
    import torch
    import torch.nn.functional as F

    from sceneverse_tpu_torch.ops import attention as fa

    dev = torch.device("cuda")
    B, H, dh = 32, 12, 64
    g = torch.Generator(device="cpu").manual_seed(4)
    bf = torch.bfloat16
    for L in (50, 300, 130):
        valid = torch.randint(L // 3, L + 1, (B,), generator=g)
        pad = (torch.arange(L)[None] >= valid[:, None]).to(dev)
        q, k, v, do = (torch.randn((B, H, L, dh), generator=g).to(dev, bf)
                       for _ in range(4))
        q = (q.float() * 0.125).to(bf)  # the wrapper's pre-scaled q
        ab_full = torch.randn((B, H, L, L), generator=g).to(dev)
        for ab in (None, ab_full):
            tag = f"L={L}" + (" +ab" if ab is not None else "")
            o, l, m = fa.flash_fwd(q, k, v, pad, ab)
            o2, l2, m2 = fa.flash_fwd(q, k, v, pad, ab)
            if not (torch.equal(o, o2) and torch.equal(l, l2)
                    and torch.equal(m, m2)):
                raise AssertionError(f"flash_fwd {tag}: two runs differ")
            ro, rl, rm = fa.flash_fwd_plain(q, k, v, pad, ab)
            worst = max((_err(o, ro), _err(l, rl), _err(m, rm)),
                        key=lambda e: e[0] / max(e[1], 1e-30))
            heads = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            mask = ~pad[:, None, None, :]
            if ab is not None:
                mask = ab.masked_fill(pad[:, None, None, :], -torch.inf).to(bf)

            def sdpa():
                return F.scaled_dot_product_attention(*heads, attn_mask=mask)

            lib_fwd = cuda_ms(sdpa)
            o_lib = sdpa()
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                o_lib, heads, do, retain_graph=True))
            del o_lib, heads
            # the products of the valid keys; k, v and ab of those keys
            work = H * L * dh * int(valid.sum())
            need = nbytes(q, pad) + key_bytes(valid, L, k, v, ab)
            table.add("flash_fwd", tag, "bf16", *worst,
                      cuda_ms(lambda: fa.flash_fwd(q, k, v, pad, ab)),
                      cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, pad, ab)),
                      TOL["bf16"],
                      bound(need + nbytes(o, l, m), 4 * work, "bf16"),
                      lib_fwd, device_ms=device_ms(
                          lambda: fa.flash_fwd(q, k, v, pad, ab),
                          "fa_fwd_kernel"))
            bargs = (q, k, v, pad, ab, ro, rl, rm, do)
            got = fa.flash_bwd(*bargs)
            again = fa.flash_bwd(*bargs)
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if b is not None):
                raise AssertionError(f"flash_bwd {tag}: two runs differ")
            want = fa.flash_bwd_plain(*bargs)
            worst = max((_err(a, b) for a, b in zip(got, want)
                         if b is not None),
                        key=lambda e: e[0] / max(e[1], 1e-30))
            # reads q, o, do, l, m, pad and the valid keys' k, v (+ ab);
            # writes dq, dk, dv (+ d ab); recomputes q.k and do.v and forms
            # dv, dk, dq over the valid keys (di, passed between the two
            # launches, is no input or output of the function)
            table.add("flash_bwd", tag, "bf16", *worst,
                      cuda_ms(lambda: fa.flash_bwd(*bargs)),
                      cuda_ms(lambda: fa.flash_bwd_plain(*bargs)),
                      TOL["bf16"],
                      bound(need + nbytes(ro, do, rl, rm)
                            + nbytes(q, k, v, ab),  # dq, dk, dv, d ab
                            10 * work, "bf16"),
                      lib_bwd, device_ms=device_ms(
                          lambda: fa.flash_bwd(*bargs), "fa_dq_kernel",
                          "fa_dkv_kernel"))
            del o, l, m, o2, l2, m2, ro, rl, rm, got, again, want
        torch.cuda.empty_cache()
    flash_pad_tail(table, g)


def flash_pad_tail(table, g):
    """``flash_fwd`` and ``flash_bwd`` at L=300 with valid lengths of 1-127
    keys, so that the kernels skip whole trailing key tiles of pad (the
    forward and the dq launch stop their walks after the tile holding a
    row's last valid key, the dk/dv launch writes zeros for a block of
    such keys), and one batch row with no valid key (it walks every tile
    and gets the mean of v). The skip is exact: each kernel's outputs equal
    its own outputs on keys cut after that tile, and dk, dv are zero on the
    skipped keys. The bounds count the operations of the valid keys and the
    bytes of q, o, l, m, do, the mask and the k, v the rows need
    (``key_bytes``), and of the outputs."""
    import torch
    import torch.nn.functional as F

    from sceneverse_tpu_torch.ops import attention as fa

    dev = torch.device("cuda")
    B, H, L, dh, bf = 32, 12, 300, 64, torch.bfloat16
    valid = torch.randint(1, 128, (B,), generator=g)
    valid[0] = 0
    pad = (torch.arange(L)[None] >= valid[:, None]).to(dev)
    q, k, v = (torch.randn((B, H, L, dh), generator=g).to(dev, bf)
               for _ in range(3))
    q = (q.float() * 0.125).to(bf)
    o, l, m = fa.flash_fwd(q, k, v, pad)
    again = fa.flash_fwd(q, k, v, pad)
    if not all(torch.equal(a, b) for a, b in zip((o, l, m), again)):
        raise AssertionError("flash_fwd pad tail: two runs differ")
    ro, rl, rm = fa.flash_fwd_plain(q, k, v, pad)
    worst = max((_err(o, ro), _err(l, rl), _err(m, rm)),
                key=lambda e: e[0] / max(e[1], 1e-30))
    mean_v = v[0].float().mean(1, keepdim=True).expand(H, L, dh)
    if (o[0].float() - mean_v).abs().max() > 2.0 ** -7:
        raise AssertionError("flash_fwd pad tail: the all-pad row is not "
                             "the mean of v")
    ends = [-(-int(valid[b]) // fa.BK) * fa.BK for b in range(B)]
    for b in range(1, 4):  # cut after the tile of the last valid key
        end = ends[b]
        cut = fa.flash_fwd(q[b:b + 1], k[b:b + 1, :, :end].contiguous(),
                           v[b:b + 1, :, :end].contiguous(),
                           pad[b:b + 1, :end].contiguous())
        if not all(torch.equal(a[b:b + 1], c) for a, c in zip((o, l, m), cut)):
            raise AssertionError(f"flash_fwd pad tail: row {b} differs from "
                                 "its cut keys")
    mask = ~pad[:, None, None, :]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask))
    work = H * L * dh * int(valid.sum())
    table.add("flash_fwd", "L=300 pad tail", "bf16", *worst,
              cuda_ms(lambda: fa.flash_fwd(q, k, v, pad)),
              cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, pad)),
              TOL["bf16"],
              bound(nbytes(q, pad, o, l, m) + key_bytes(valid, L, k, v),
                    4 * work, "bf16"), lib,
              device_ms=device_ms(lambda: fa.flash_fwd(q, k, v, pad),
                                  "fa_fwd_kernel"))
    del o, l, m, again
    do = torch.randn((B, H, L, dh), generator=g).to(dev, bf)
    bargs = (q, k, v, pad, None, ro, rl, rm, do)
    got = fa.flash_bwd(*bargs)
    again = fa.flash_bwd(*bargs)
    if not all(torch.equal(a, b) for a, b in zip(got[:3], again[:3])):
        raise AssertionError("flash_bwd pad tail: two runs differ")
    want = fa.flash_bwd_plain(*bargs)
    worst = max((_err(a, b) for a, b in zip(got[:3], want[:3])),
                key=lambda e: e[0] / max(e[1], 1e-30))
    for a, b in zip(got[:3], want[:3]):  # the all-pad row, every tile
        err, scale = _err(a[0], b[0])
        if not err <= TOL["bf16"] * scale:
            raise AssertionError("flash_bwd pad tail: the all-pad row is "
                                 f"{err / scale:.3e} from the twin")
    dq, dk, dv, _ = got
    for b in range(1, B):
        if (dk[b, :, ends[b]:].any() or dv[b, :, ends[b]:].any()):
            raise AssertionError(f"flash_bwd pad tail: row {b} has non-zero "
                                 "dk or dv on its skipped pad keys")
    for b in range(1, 4):
        end, r = ends[b], slice(b, b + 1)
        cut = fa.flash_bwd(q[r], k[r, :, :end].contiguous(),
                           v[r, :, :end].contiguous(),
                           pad[r, :end].contiguous(), None, ro[r], rl[r],
                           rm[r], do[r])
        if not (torch.equal(dq[r], cut[0])
                and torch.equal(dk[r, :, :end], cut[1])
                and torch.equal(dv[r, :, :end], cut[2])):
            raise AssertionError(f"flash_bwd pad tail: row {b} differs from "
                                 "its cut keys")
    heads = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*heads, attn_mask=mask)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, heads, do,
                                                  retain_graph=True))
    del o_lib, heads
    table.add("flash_bwd", "L=300 pad tail", "bf16", *worst,
              cuda_ms(lambda: fa.flash_bwd(*bargs)),
              cuda_ms(lambda: fa.flash_bwd_plain(*bargs)),
              TOL["bf16"],
              bound(nbytes(q, pad, ro, rl, rm, do)
                    + key_bytes(valid, L, k, v)
                    + nbytes(q, k, v),  # dq, dk, dv
                    10 * work, "bf16"), lib_bwd,
              device_ms=device_ms(lambda: fa.flash_bwd(*bargs),
                                  "fa_dq_kernel", "fa_dkv_kernel"))
    torch.cuda.empty_cache()


def phase_sample_group(table):
    """``ball_group`` at SA1 of the unfrozen slice, on the slice's kind of
    data (standard-normal points, as the synthetic dataset draws them), with
    all-pad objects and empty balls, in exact and fast mode."""
    import torch

    from sceneverse_tpu_torch.ops import sa_forward as sa
    from sceneverse_tpu_torch.ops import sample_group as sg

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2)
    G, N, C, m, ns, r = 32 * 80, 1024, 6, 32, 32, 0.2
    pts = torch.randn((G, N, C), generator=g)
    pts[-8:, :, :3] = 0.0  # all-pad objects: FPS repeats index 0
    pts = pts.to(dev)
    xyz = pts[..., :3].contiguous()
    centers, fps_idx = sa.fps(xyz, m)
    if not torch.equal(fps_idx, sa.fps_plain(xyz, m)[1]):
        raise AssertionError("fps indices differ at the ball_group shapes")
    if not bool((fps_idx[-8:] == 0).all()):
        raise AssertionError("fps on an all-pad object must repeat index 0")
    shifted = centers.clone()
    shifted[:8] += 5.0  # objects whose balls are all empty
    tag = f"SA1 G={G} N={N} C={C} m={m} ns={ns}"
    for label, ctr in (("", centers), (" +empty", shifted)):
        cnt = ball_counts(xyz, ctr, r)
        for mode in ("exact", "fast"):
            exact = mode == "exact"
            got, got_idx = sg.ball_group(pts, ctr, ns, r, exact)
            want, want_idx = sg.ball_group_plain(pts, ctr, ns, r, exact)
            mism = int((got_idx != want_idx).sum())
            if mism:
                raise AssertionError(f"ball_group {tag}{label} {mode}: "
                                     f"{mism} indices differ")
            again = sg.ball_group(pts, ctr, ns, r, exact)
            if not (torch.equal(got, want) and torch.equal(got, again[0])
                    and torch.equal(got_idx, again[1])):
                raise AssertionError(f"ball_group {tag}{label} {mode}: not "
                                     "equal to the twin or between two runs")
            # a warp stops at the ns-th hit, else scans all N points
            scanned = torch.where(cnt >= ns, want_idx[..., -1].long() + 1,
                                  torch.full_like(cnt, N)).sum().item()
            bnd = bound(nbytes(pts, ctr, want, want_idx), 8 * scanned, "f32")
            table.add("ball_group", tag + label,
                      "f32" if exact else "f32-fast", *_err(got, want),
                      cuda_ms(lambda: sg.ball_group(pts, ctr, ns, r, exact)),
                      cuda_ms(lambda: sg.ball_group_plain(pts, ctr, ns, r,
                                                          exact), reps=3),
                      BG_TOL[mode], bnd,
                      device_ms=device_ms(
                          lambda: sg.ball_group(pts, ctr, ns, r, exact),
                          "sv_ball_group_kernel"))
        log(f"[kernel] ball_group {tag}{label}: mean in-ball count "
            f"{cnt.float().mean().item():.2f}, empty balls "
            f"{int((cnt == 0).sum())}, full balls {int((cnt >= ns).sum())}")
    del pts, xyz, got, want
    torch.cuda.empty_cache()


def _sa_train_flops(R, dims, upto, kind, need_dx=True):
    """Operations of one call: the chain's products once, plus the Gram
    (stats: symmetric, so its upper triangle, R * H * (H + 1)), the dsym
    product (stats backward, a full product) and the dW and d_prev products
    of each layer (backward). dims = [C, H1, H2, H3]."""
    mm = [2 * R * k * h for k, h in zip(dims[:upto], dims[1:upto + 1])]
    H = dims[upto]
    if kind == "stats":
        return sum(mm) + R * H * (H + 1)
    if kind == "pool":
        return sum(mm)
    extra = 2 * R * H * H if kind == "stats_bwd" else 0
    back = sum(mm) + sum(mm[1:]) + (mm[0] if need_dx else 0)
    return sum(mm) + extra + back


def _tensors(o):
    """The tensors of a nest of tuples and lists, in order."""
    if isinstance(o, (tuple, list)):
        return [t for i in o for t in _tensors(i)]
    return [] if o is None else [o]


def _sa_train_check(table, name, tag, got, want, tol, bnd, ms, plain_ms):
    """Largest relative error over the outputs of one call; raises past
    ``tol``."""
    worst = max((_err(g, w) for g, w in zip(got, want)),
                key=lambda e: e[0] / max(e[1], 1e-30))
    table.add(name, tag, "f32", *worst, ms, plain_ms, tol, bnd)


# the fused unfreeze slice's three SA levels: (label, centers per object,
# ns, dims, dx needed)
SA_TRAIN_LEVELS = [
    ("SA1", 32, 32, [6, 64, 64, 128], False),
    ("SA2", 16, 32, [131, 128, 128, 256], True),
    ("SA3", 1, 16, [259, 256, 512, 768], True),
]


# SA2's pooled centers (32 x 80 objects x 16), the count the grads
# tolerance of SA_TRAIN_TOL was derived at
SA_TRAIN_POOLED_REF = 32 * 80 * 16


def pool_bwd_grads_tol(pooled):
    """``sa_pool_bwd``'s grads tolerance over ``pooled`` centers, by the
    derivation of SA_TRAIN_TOL["grads"]: one ReLU decision landing the
    other way moves one pooled row's term whole, about 1 / sqrt(pooled) of
    max|plain|, so the tolerance keeps SA2's margin over fewer rows: 4e-2
    at SA3's 2560. At SA3 the twin against itself with its input channels
    permuted, the same function summed in another order, is off by up to
    1.2e-2 at both 512 and 768 wide (``sa_train_spread.py``, an H100)."""
    return SA_TRAIN_TOL["grads"] * max(
        1.0, math.sqrt(SA_TRAIN_POOLED_REF / pooled))


def phase_sa_train(table, levels=SA_TRAIN_LEVELS, per_level_tol=False):
    """The four ``sa_train`` kernels against their plain twins at the SA
    levels of the fused unfreeze slice (or ``levels``, G = 32 x 80
    objects): standard-normal grouped rows, random weights, BN scales
    (0.5-1.5) and shifts, random cotangents. Each kernel also runs twice
    and must give bit-identical outputs. With ``per_level_tol``,
    ``sa_pool_bwd``'s grads are held to ``pool_bwd_grads_tol`` of the
    level's pooled centers, and the twin's own spread under a permutation
    of its input channels is logged beside."""
    import torch

    from sceneverse_tpu_torch.ops import sa_train as st

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    G = 32 * 80
    for label, m, ns, dims, need_dx in levels:
        R = G * m * ns
        tag = f"{label} R={R} {dims[0]}->{dims[1]},{dims[2]},{dims[3]}"
        x = torch.randn((R, dims[0]), generator=g).to(dev)
        params = tuple(
            ((torch.randn((k, h), generator=g) / math.sqrt(k)).to(dev),
             (torch.rand(h, generator=g) + 0.5).to(dev),
             (torch.randn(h, generator=g) * 0.1).to(dev))
            for k, h in zip(dims[:-1], dims[1:]))
        wbytes = sum(nbytes(w.to(torch.bfloat16), a, b) for w, a, b in params)

        def twice(fn):
            a, b = fn(), fn()
            if not all(torch.equal(p, q) for p, q in zip(_tensors(a),
                                                          _tensors(b))):
                raise AssertionError(f"{fn.__name__} {tag}: two runs differ")
            return a

        for upto in (1, 2):
            H = dims[upto]

            def stats():
                return st.sa_stats(x, params, upto)
            got = twice(stats)
            want = st.mlp_stats_plain(x, params, upto)
            bnd = bound(nbytes(x, *want) + wbytes,
                        _sa_train_flops(R, dims, upto, "stats"), "bf16")
            _sa_train_check(table, "sa_stats", f"{tag} upto={upto}", got,
                            want, SA_TRAIN_TOL["sums"], bnd, cuda_ms(stats),
                            cuda_ms(lambda: st.mlp_stats_plain(x, params,
                                                               upto), 3))
            dS = torch.randn(H, generator=g).to(dev)
            dG = (torch.randn((H, H), generator=g) / H).to(dev)

            def stats_bwd():
                return st.sa_stats_bwd(x, params, upto, dS, dG, need_dx)
            dx, grads = twice(stats_bwd)
            wdx, wgrads = st.mlp_stats_bwd_plain(x, params, upto, dS, dG)
            got = [t for gr in grads for t in gr]
            want = [t for gr in wgrads for t in gr]
            bnd = bound(nbytes(x, dS, dG, *want) + wbytes
                        + (nbytes(x) if need_dx else 0),
                        _sa_train_flops(R, dims, upto, "stats_bwd", need_dx),
                        "bf16")
            _sa_train_check(table, "sa_stats_bwd", f"{tag} upto={upto}",
                            got, want, SA_TRAIN_TOL["grads"], bnd,
                            cuda_ms(stats_bwd),
                            cuda_ms(lambda: st.mlp_stats_bwd_plain(
                                x, params, upto, dS, dG), 3))
            if need_dx:
                check_rows("sa_stats_bwd dx", tag, dx, wdx)
            del got, want, grads, wgrads, dx, wdx

        def pool():
            return st.sa_pool(x, params, ns)
        pooled, arg = twice(pool)
        wpooled, warg = st.mlp_pool_plain(x, params, ns)
        check_argmax(tag, x, params, ns, pooled, arg, wpooled, warg)
        bnd = bound(nbytes(x, wpooled, warg) + wbytes,
                    _sa_train_flops(R, dims, 3, "pool"), "bf16")
        _sa_train_check(table, "sa_pool", tag, [pooled], [wpooled],
                        SA_TRAIN_TOL["pooled"], bnd, cuda_ms(pool),
                        cuda_ms(lambda: st.mlp_pool_plain(x, params, ns), 3))
        dpooled = torch.randn(pooled.shape, generator=g).to(dev)

        def pool_bwd():
            return st.sa_pool_bwd(x, params, ns, dpooled, arg, need_dx)
        dx, grads = twice(pool_bwd)
        wdx, wgrads = st.mlp_pool_bwd_plain(x, params, ns, dpooled, arg)
        got = [t for gr in grads for t in gr]
        want = [t for gr in wgrads for t in gr]
        bnd = bound(nbytes(x, dpooled, arg, *want) + wbytes
                    + (nbytes(x) if need_dx else 0),
                    _sa_train_flops(R, dims, 3, "pool_bwd", need_dx), "bf16")
        grads_tol = SA_TRAIN_TOL["grads"]
        if per_level_tol:
            grads_tol = pool_bwd_grads_tol(G * m)
            perm = torch.randperm(dims[0], generator=g).to(dev)
            _, pgrads = st.mlp_pool_bwd_plain(
                x[:, perm].contiguous(),
                ((params[0][0][perm],) + params[0][1:],) + params[1:], ns,
                dpooled, arg)
            pgot = [t for gr in pgrads for t in gr]
            pgot[0] = pgot[0][torch.argsort(perm)]
            spread = max(a / max(b, 1e-30) for a, b in
                         (_err(p, w) for p, w in zip(pgot, want)))
            log(f"[kernel] sa_pool_bwd twin {tag}: against itself with its "
                f"input channels permuted, max_rel_err {spread:.3e}; grads "
                f"tolerance {grads_tol:.3g} over {G * m} pooled centers")
            del pgrads, pgot
        _sa_train_check(table, "sa_pool_bwd", tag, got, want,
                        grads_tol, bnd, cuda_ms(pool_bwd),
                        cuda_ms(lambda: st.mlp_pool_bwd_plain(
                            x, params, ns, dpooled, arg), 3))
        if need_dx:
            check_rows("sa_pool_bwd dx", tag, dx, wdx)
        del x, got, want, grads, wgrads, dx, wdx, pooled, wpooled
        torch.cuda.empty_cache()


def check_rows(name, tag, got, want):
    """Per-row outputs (dx): a ReLU decision that lands the other way in
    one row (u summed in another order, |z| within an ulp of 0) moves that
    row alone, so all but a 1e-4 share of the elements must be within
    ``rows`` of max|want| and none beyond ``rows_max``."""
    import torch

    scale = want.abs().max().item()
    err = (got - want).abs()
    share = (err > SA_TRAIN_TOL["rows"] * scale).float().mean().item()
    worst = err.max().item() / scale
    log(f"[kernel] {name:18s} {tag}: max_rel_err={worst:.3e}, share beyond "
        f"{SA_TRAIN_TOL['rows']:g}: {share:.2e}")
    if not (share <= 1e-4 and worst <= SA_TRAIN_TOL["rows_max"]
            and torch.isfinite(got).all()):
        raise AssertionError(f"{name} {tag}: {worst} / {share}")


def check_argmax(tag, x, params, ns, pooled, arg, wpooled, warg):
    """The argmax must equal the twin's, except at near-ties: at most an
    ``arg_share`` of the entries may differ, and where one does, the twin's
    h3 at the kernel's slot must lie within ``pooled`` of the center's own
    max|pooled| (over its channels) of the twin's max."""
    import torch

    from sceneverse_tpu_torch.ops import sa_train as st

    diff = arg != warg
    n = int(diff.sum())
    share = n / arg.numel()
    worst = 0.0
    if n:
        h3 = st.chain_plain(x, params, 3)[-1].reshape(*pooled.shape[:1], ns,
                                                      -1)
        at = torch.gather(h3, 1, arg.long()[:, None, :])[:, 0]
        center = wpooled.abs().amax(1, keepdim=True).expand_as(wpooled)
        worst = ((at - wpooled).abs()[diff]
                 / center[diff].clamp_min(1e-30)).max().item()
        del h3, at, center
    log(f"[kernel] sa_pool argmax {tag}: {n} of {arg.numel()} differ "
        f"(share {share:.2e}, tol {SA_TRAIN_TOL['arg_share']:g}), largest "
        f"gap {worst:.3e} of the center's max (tol "
        f"{SA_TRAIN_TOL['pooled']:g})")
    if share > SA_TRAIN_TOL["arg_share"] or worst > SA_TRAIN_TOL["pooled"]:
        raise AssertionError(f"sa_pool {tag}: argmax differs at {n} places "
                             f"(share {share}), gap {worst}")


def check_mha(table, label, dname, q, k, v, pad, sw, locs, do, H, scale,
              rate, seed):
    """``mha_fwd`` and ``mha_bwd`` on one call's operands against their
    twins, each run twice and required bit-identical, with a row each in the
    table: the kernels' and the twins' times, SDPA's on the same heads,
    bias and dropout, and the bound. The f32 bound counts the products at
    the 3xTF32 rate of the tensor cores (``PEAK["3xtf32"]``), the way the
    kernels form them."""
    import torch
    import torch.nn.functional as F

    from sceneverse_tpu_torch.ops import mha

    B, L, D = q.shape
    T, dh = k.shape[1], D // H
    if seed is not None and not torch.is_tensor(seed):
        # the kernels read it from device memory
        seed = torch.tensor([seed], device=q.device)
    args = (q, k, v, pad, sw, locs, H, scale, rate, seed)
    o, lse = mha.mha_fwd(*args)
    o2, lse2 = mha.mha_fwd(*args)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"mha_fwd {label} {dname}: two runs differ")
    o_ref, lse_ref = mha.mha_fwd_plain(*args)
    lerr, lscale = _err(lse, lse_ref)
    if lerr > TOL["f32"] * lscale:
        raise AssertionError(f"mha_fwd lse {label} {dname}: {lerr}")
    # library yardstick: one SDPA call on the same heads, the same additive
    # bias (pad [+ the precomputed 'cond' gate]) and dropout
    heads = [t.view(B, -1, H, dh).transpose(1, 2).detach().requires_grad_()
             for t in (q, k, v)]
    bias = (mha._scores(torch.zeros_like(q), k, pad, sw, locs, H, scale)[0]
            if sw is not None else pad[:, None, None, :]).to(q.dtype)

    def sdpa():
        return F.scaled_dot_product_attention(
            *heads, attn_mask=bias, dropout_p=rate, scale=scale)

    lib_fwd = cuda_ms(sdpa)
    o_lib = sdpa()
    do_h = do.view(B, L, H, dh).transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, heads, do_h,
                                                  retain_graph=True))
    del o_lib
    el = q.element_size()
    qkvo = 2 * B * (L + T) * D * el
    gate_b = nbytes(sw, locs)
    work = B * H * L * T * dh
    peak = "3xtf32" if q.dtype == torch.float32 else dname
    table.add("mha_fwd", label, dname, *_err(o, o_ref),
              cuda_ms(lambda: mha.mha_fwd(*args)),
              cuda_ms(lambda: mha.mha_fwd_plain(*args)), TOL[dname],
              bound(qkvo + nbytes(pad, lse) + gate_b, 4 * work, peak),
              lib_fwd)
    bargs = (q, k, v, pad, sw, locs, do, o_ref, lse_ref, H, scale, rate, seed)
    got = mha.mha_bwd(*bargs)
    again = mha.mha_bwd(*bargs)
    if not all(torch.equal(a, b) for a, b in zip(got, again)
               if b is not None):
        raise AssertionError(f"mha_bwd {label} {dname}: two runs differ")
    want = mha.mha_bwd_plain(*bargs)
    errs = [_err(a, b) for a, b in zip(got, want) if b is not None]
    worst = max(errs, key=lambda e: e[0] / max(e[1], 1e-30))
    # reads q, k, v, do, o, lse, pad (+ gate); writes dq, dk, dv (+ dsw);
    # recomputes q.k and do.v and forms dv, dq, dk
    table.add("mha_bwd", label, dname, *worst,
              cuda_ms(lambda: mha.mha_bwd(*bargs)),
              cuda_ms(lambda: mha.mha_bwd_plain(*bargs)), TOL[dname],
              bound(2 * qkvo + nbytes(pad, lse) + gate_b + nbytes(sw),
                    10 * work, peak), lib_bwd)


def phase_mha(table):
    """``mha_fwd`` and ``mha_bwd`` against their twins at the four GPS
    attention shapes (B=32, H=12, dh=64) and the grounding variants' two
    cross-attention shapes (queries and keys of different lengths: 80
    objects over 50 tokens, 50 over 80), f32 and bf16 (``check_mha``)."""
    import torch

    from sceneverse_tpu_torch.ops import mha

    dev = torch.device("cuda")
    B, H, dh = 32, 12, 64
    D = H * dh
    fmin = torch.finfo(torch.float32).min
    cases = [  # (label, L queries, T keys, pad kind, gate, dropout)
        ("bert L=50 additive drop0.1", 50, 50, "additive", False, 0.1),
        ("caption L=300 additive drop0.1", 300, 300, "additive", False, 0.1),
        ("spatial-cond L=80 keypad", 80, 80, "keypad", True, 0.0),
        ("unified L=130 keypad drop0.1", 130, 130, "keypad", False, 0.1),
        ("cross L=80 T=50 keypad drop0.1", 80, 50, "keypad", False, 0.1),
        ("cross L=50 T=80 keypad drop0.1", 50, 80, "keypad", False, 0.1),
    ]
    g = torch.Generator(device="cpu").manual_seed(1)
    for label, L, T, padkind, gate, rate in cases:
        valid = torch.randint(T // 3, T + 1, (B,), generator=g)
        padmask = torch.arange(T)[None] >= valid[:, None]
        pad = torch.where(padmask, fmin if padkind == "additive" else mha.NEG,
                          0.0).float().to(dev)
        sw = (torch.randn((B, H, L, 6), generator=g).to(dev) if gate else None)
        locs = (torch.randn((B, L, T, 5), generator=g).to(dev) if gate
                else None)
        base = [torch.randn((B, n, D), generator=g).to(dev)
                for n in (L, T, T, L)]  # q, k, v, do
        for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v, do = (t.to(dtype) for t in base)
            check_mha(table, label, dname, q, k, v, pad, sw, locs, do, H,
                      1.0 / math.sqrt(dh), rate, 77)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def gates(env):
    """``env`` set in ``os.environ`` for the block alone."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_slice(name, extra, env):
    """Drive one slice through ``run_torch.main`` with ``env`` set for it
    alone; returns its launches and its step time, throughput and peak
    memory."""
    with gates(env):
        return _run_slice(name, extra)


def _run_slice(name, extra):
    import torch

    import run_torch
    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    # experiment dirs (config, metrics, best.pth) go under build/, which git
    # ignores, not into the small chiprun_out/
    args = SLICE_ARGS + extra + [
        "solver.log_every=1",
        f"base_dir={os.path.join(REPO, 'build', 'smoke_runs', name)}"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    result = run_torch.main(args)
    launches = dict(_build.LAUNCHES)
    trainer = result["trainer"]
    tag = f"[slice {name}]"
    log(f"{tag} launches on the path: {launches}")
    hist = trainer.history
    for row in hist["train"]:
        log(f"{tag} step {row['step']} loss {row['total_loss']:.5f} "
            f"step_s {row['step_s']:.4f}")
    steady = [r["step_s"] for r in hist["train"][1:]]
    step_s = statistics.mean(steady) if steady else float("nan")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} steps {len(hist['train'])}, steady step {step_s:.4f} s "
        f"(mean after the first), batch 32 -> {32 / step_s:.2f} scenes/s, "
        f"peak memory {peak:.2f} GiB")
    log(f"{tag} val {hist['val']}")
    log(f"{tag} test {hist['test']}")
    losses = [r["total_loss"] for r in hist["train"]]
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name} slice losses not finite / not 4 steps: "
                             f"{losses}")
    for key in ("val", "test"):
        if not hist[key] or not all(math.isfinite(v) for v in
                                    hist[key][-1].values()):
            raise AssertionError(f"{name} slice: {key} eval missing or not "
                                 "finite")
    for k in PATHS[name][1]:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the {name} "
                                 "path")
    if name == "unfrozen_fused":  # every SA level took the fused path
        steps = len(hist["train"])
        for k, n in SA_TRAIN_PER_STEP.items():
            if launches.get(k, 0) != n * steps:
                raise AssertionError(f"{k}: {launches.get(k, 0)} launches, "
                                     f"expected {n} x {steps} train steps")
    info = {}
    if name == "frozen_exact":
        n_eval = sum(len(trainer.data_loaders[s]) for s in ("val", "test"))
        check_exact_launches(tag, launches, len(hist["train"]), n_eval)
        info = {"best_pth": str(trainer.ckpt_path / "best.pth"),
                "test": hist["test"][-1]}
        info.update(time_eval(tag, trainer))
    if name.startswith("unfrozen"):
        # the same seeded build the trainer made, against what it trained
        cfg = trainer.cfg
        built = build_model(cfg, generator=torch.Generator().manual_seed(
            int(cfg.get("rng_seed", 42)))).state_dict()
        trained = trainer.model.state_dict()
        pnet = [k for k in built if k.startswith(
            "point_encoder.point_feature_extractor.")
            and not k.endswith("num_batches_tracked")]
        same = [k for k in pnet
                if torch.equal(built[k], trained[k].detach().cpu())]
        log(f"{tag} PointNet++ tensors changed by training: "
            f"{len(pnet) - len(same)} of {len(pnet)}")
        if same or len(pnet) != 3 * 3 * 5 + 2:
            raise AssertionError(f"PointNet++ tensors unchanged: {same}")
    info.update({"steady_step_s": step_s, "scenes_per_s": 32 / step_s,
                 "peak_mem_gib": peak, "launches": launches})
    del result, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return info


def check_exact_launches(tag, launches, n_train, n_eval):
    """The exact-mode path: no fused MHA at all; SA1 and SA2 through
    ``sa_group_mlp_pool`` and ``sa_dense_pool`` once per forward; flash
    attention FLASH_PER_EVAL_BATCH times per eval batch and never in a
    train step (dropout is active there)."""
    want = {"mha_fwd": 0, "mha_bwd": 0, "flash_bwd": 0,
            "sa_group_mlp_pool": n_train + n_eval,
            "sa_dense_pool": n_train + n_eval,
            "flash_fwd": FLASH_PER_EVAL_BATCH * n_eval}
    got = {k: launches.get(k, 0) for k in want}
    log(f"{tag} exact-mode launches {got} ({n_train} train steps, {n_eval} "
        "eval batches)")
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")


def time_eval(tag, trainer):
    """One more test pass, timed on the host clock around work that ends in
    a synchronise, with its own peak memory. The run has closed its
    metrics log, so this pass logs nothing."""
    import torch

    from sceneverse_tpu_torch.trainer.build import to_device

    trainer.log = lambda *a, **k: None
    loaders = trainer.data_loaders["test"]
    loaders = loaders if isinstance(loaders, list) else [loaders]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.test_step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    scenes = sum(len(loader.dataset) for loader in loaders)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the forwards alone, on batches made and moved to the card beforehand
    batches = [to_device(b, trainer.device) for ld in loaders for b in ld]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.forward(b)
    torch.cuda.synchronize()
    fwd = time.perf_counter() - t0
    log(f"{tag} test pass {dt:.4f} s for {scenes} scenes -> "
        f"{scenes / dt:.2f} eval scenes/s (forwards alone {fwd:.4f} s -> "
        f"{scenes / fwd:.2f} scenes/s), peak memory {peak:.2f} GiB")
    return {"eval_s": dt, "eval_scenes_per_s": scenes / dt,
            "eval_forward_s": fwd, "eval_forward_scenes_per_s": scenes / fwd,
            "eval_peak_mem_gib": peak}


def phase_entry(exact):
    """``run_torch.main`` with ``mode=test pretrain_ckpt_path=`` the
    frozen_exact slice's ``best.pth``, under the same gates: it loads every
    tensor of the model's state dict and reproduces the slice's test
    metrics (``best_result`` aside: the evaluator's best over a run's
    passes, val included)."""
    with gates(EXACT_ENV):
        return _run_entry(exact)


def _run_entry(exact):
    import torch

    import run_torch
    from sceneverse_tpu_torch.ops import _build

    tag = "[entry mode=test]"
    args = SLICE_ARGS + [
        "mode=test", f"pretrain_ckpt_path={exact['best_pth']}",
        f"base_dir={os.path.join(REPO, 'build', 'smoke_runs', 'exact_test')}"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    result = run_torch.main(args)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer = result["trainer"]
    n_state = len(trainer.model.state_dict())
    log(f"{tag} loaded {trainer.pretrain_loaded} of {n_state} tensors; "
        f"launches {launches}; peak memory {peak:.2f} GiB")
    if trainer.pretrain_loaded != n_state:
        raise AssertionError(f"{tag}: loaded {trainer.pretrain_loaded} of "
                             f"{n_state} tensors")
    if trainer.history["train"] or list(trainer.data_loaders) != ["test"]:
        raise AssertionError(f"{tag}: trained or built other loaders")
    check_exact_launches(tag, launches, 0, len(trainer.data_loaders["test"]))
    got, want = result["results"], exact["test"]
    keys = sorted(set(want) - {"best_result"})
    if set(got) != set(want):
        raise AssertionError(f"{tag}: metrics {sorted(got)} vs {sorted(want)}")
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
              if got[k] != want[k] else 0.0 for k in keys)
    log(f"{tag} test metrics {got}; max relative difference to the slice's "
        f"{rel:.3e}")
    if not rel <= 1e-6:
        raise AssertionError(f"{tag}: test metrics differ by {rel}")
    info = time_eval(tag, trainer)
    info.update({"loaded": trainer.pretrain_loaded, "state_tensors": n_state,
                 "max_rel_diff": rel, "peak_mem_gib": peak,
                 "launches": launches})
    del result, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return info


# ------------------------------------------------------------ trainer phase
# the multi-step run of the trainer phase: 4 steps an epoch, 8 epochs (32
# steps), val every 4 epochs, ckpt_N every 4; trainer A is cut after epoch
# TRAINER_CUT, as a preemption would cut it, and a fresh trainer B resumes;
# 32 steps (formerly 40, 80, and 240 before that) keep the whole smoke
# within its time budget, and the loss and train-accuracy checks compare
# the means of their first and last TRAINER_HALF steps (at 40 steps the
# means of steps 1-20 and 21-40 were 14.654 and 9.726, the target
# metric's 0.022 and 0.167)
TRAINER_RUN = ["data.synthetic_size=128", "solver.epochs=8",
               "solver.epochs_per_eval=4", "solver.epochs_per_save=4"]
TRAINER_CUT = 4
TRAINER_HALF = 16
# remat against no remat, per gradient tensor, on max|diff| / max|no remat|;
# the trainer's accumulated (clipped) gradient at its first update against
# the hand-taken mean's, per tensor, on max|diff| / max|hand|
REMAT_TOL = 1e-5
ACCUM_TOL = 1e-5
# the first update's parameters against the hand-taken update's, per tensor:
# at most ACCUM_SHARE of the elements off by more than 1e-5 * max|p| + 1e-2
# * lr. AdamW's first step moves an element by lr * g / (|g| + eps), about
# lr * sign(g): where g is near 0, the last-bit difference between the
# running mean and the plain mean, or an atomic sum of the backward that
# lands in another order (the no-remat run against itself shows them),
# turns into a visible fraction of lr
ACCUM_SHARE = 1e-3


def _trainer(name, extra):
    """A trainer of the frozen f32 slice at full width (``SLICE_ARGS``),
    configured as ``run_torch.load_cfg`` configures one, its experiment
    under build/smoke_runs/trainer/<name>."""
    import run_torch
    from sceneverse_tpu_torch.trainer.build import build_trainer

    exp = os.path.join(REPO, "build", "smoke_runs", "trainer", name)
    cfg = run_torch.load_cfg(SLICE_ARGS + extra + [f"exp_dir={exp}"])
    return build_trainer(cfg)


def _free():
    """Collect what a finished sub-phase left (its trainers hold reference
    cycles) and hand the cached blocks back."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def kernel_sum_ms(fn):
    """(device ms, device events) of one call of ``fn`` after a warm-up:
    every kernel, copy and fill it put on the card, summed
    (torch.profiler). A window can lose events (``device_ms``): the call
    is traced again until a window traces as many events as an earlier
    one that traced any, up to PROFILER_WINDOWS windows."""
    import torch

    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(PROFILER_WINDOWS):
        events = _traced(fn, 1)
        if events and len(events) in seen:
            return (sum(e.time_range.elapsed_us() for e in events) / 1e3,
                    len(events))
        if seen or not events:
            log(f"[kernel_sum_ms] {len(events)} device events traced, "
                f"{seen} in the windows before (window {attempt + 1} of "
                f"{PROFILER_WINDOWS})")
        if events:
            seen.append(len(events))
    raise AssertionError(f"kernel_sum_ms: no two windows traced the same "
                         f"device events in {PROFILER_WINDOWS}: {seen}")


def remat_extra_fwd(cfg):
    """``mha_fwd`` launches that ``model.remat=true`` adds to a train step:
    the recompute runs every fused attention layer of the language towers
    (the utterance tower, and the split caption tower but for its
    ``cls_only`` last layer, which takes the plain path) and of the
    grounding tower once more."""
    from sceneverse_tpu_torch.model.openvocab import cap_cls_only_enabled

    L = int(cfg.model.language.args.num_hidden_layers)
    G = int(cfg.model.grounding.args.num_layers)
    caption = 0
    if cfg.model.get("split_scene_cap_tower", False):
        caption = L - 1 if cap_cls_only_enabled() else L
    return L + caption + G


def trainer_remat():
    """One train step's forward and backward from the same weights, batch
    and generator states, with no remat, ``model.remat=true`` under "full"
    and under "dots" (dropout on): losses bit-equal, every gradient within
    REMAT_TOL, both generators' states equal after the step, the recompute's
    ``mha_fwd`` launches as ``remat_extra_fwd`` counts them and a lower peak
    under "full"; for each way the CUDA-event time of the step (median of
    3) and the device time of its kernels (``kernel_sum_ms``)."""
    import torch

    from sceneverse_tpu_torch.modules.utils import _streams
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.trainer.build import to_device

    tag = "[trainer remat]"
    t = _trainer("remat", [])
    model = t.model
    batch = to_device(next(iter(t.data_loaders["train"])), t.device)
    gens = _streams(model)
    start = [g.get_state() for g in gens]
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def step():
        for g, state in zip(gens, start):
            g.set_state(state)
        t.optimizer.zero_grad()
        model.train()
        total, _ = t.loss(model(batch))
        total.backward()
        return total

    res = {}
    # "again": no remat once more, the run-to-run spread of the backward
    for way in ("none", "again", "full", "dots"):
        model.remat = (set() if way in ("none", "again")
                       else {"language", "grounding"})
        model.remat_policy = way if way in ("full", "dots") else "full"
        step()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        total = step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: _build.LAUNCHES.get(k, 0) for k in ("mha_fwd", "mha_bwd")}
        res[way] = {"loss": total.item(), "peak_gib": peak / 2 ** 30,
                    "launches": launches,
                    "states": [g.get_state() for g in gens],
                    "grads": {n: p.grad.detach().cpu() for n, p in params
                              if p.grad is not None}}
        res[way]["step_ms"] = cuda_ms(step, reps=3)
        res[way]["kernel_ms"], n_events = kernel_sum_ms(step)
        log(f"{tag} {way}: loss {res[way]['loss']!r} peak "
            f"{res[way]['peak_gib']:.3f} GiB, launches {launches}, "
            f"forward + backward {res[way]['step_ms']:.3f} ms (CUDA events), "
            f"device {res[way]['kernel_ms']:.3f} ms in {n_events} kernels, "
            f"copies and fills (torch.profiler)")
    ref = res["none"]
    extra = remat_extra_fwd(t.cfg)
    for way in ("again", "full", "dots"):
        got = res[way]
        if got["loss"] != ref["loss"]:
            raise AssertionError(f"{tag} {way}: loss {got['loss']!r} vs "
                                 f"{ref['loss']!r}")
        if set(got["grads"]) != set(ref["grads"]):
            raise AssertionError(f"{tag} {way}: other gradient tensors")
        worst = max(((got["grads"][n] - g0).abs().max().item()
                     / max(g0.abs().max().item(), 1e-30), n)
                    for n, g0 in ref["grads"].items())
        got["max_rel_grad_err"] = worst[0]
        log(f"{tag} {way}: gradients "
            + ("bit-equal to the first no-remat run" if worst[0] == 0.0 else
               f"NOT bit-equal to the first no-remat run: max rel "
               f"{worst[0]:.3e} at {worst[1]}"))
        if not worst[0] <= REMAT_TOL:
            raise AssertionError(f"{tag} {way}: gradient {worst[1]} off by "
                                 f"{worst[0]} relative")
        if not all(torch.equal(a, b) for a, b in zip(got["states"],
                                                     ref["states"])):
            raise AssertionError(f"{tag} {way}: generator states differ")
        want = {"mha_fwd": ref["launches"]["mha_fwd"]
                + (extra if way != "again" else 0),
                "mha_bwd": ref["launches"]["mha_bwd"]}
        if got["launches"] != want:
            raise AssertionError(f"{tag} {way}: launches {got['launches']}, "
                                 f"expected {want}")
    if not res["full"]["peak_gib"] < ref["peak_gib"]:
        raise AssertionError(f"{tag} full: peak {res['full']['peak_gib']} GiB "
                             f"not below no remat's {ref['peak_gib']}")
    return {way: {k: v for k, v in r.items() if k not in ("grads", "states")}
            for way, r in res.items()}


def trainer_accum():
    """``solver.gradient_accumulation_steps=2`` over one epoch of 4
    micro-steps (warmup 0, so the first update has a non-zero LR): the
    parameters are bit-unchanged after micro-steps 1 and 3 and moved after
    2 and 4, two optimizer steps, the logged LR is the schedule over
    ``total // 2``, and the first update equals one taken by hand from the
    mean of the first two micro-batches' gradients (a second model of the
    same seeded build and generators, the same batches): the clipped
    gradient AdamW takes within ACCUM_TOL, the parameters within
    ACCUM_SHARE."""
    import torch

    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.modules.utils import set_generators
    from sceneverse_tpu_torch.optim.build import GPSOptimizer
    from sceneverse_tpu_torch.trainer.build import build_dataloader, to_device

    tag = "[trainer accum]"
    K = 2
    t = _trainer("accum", [f"solver.gradient_accumulation_steps={K}",
                           "solver.sched.args.warmup_steps=0",
                           "solver.log_every=1"])
    cfg = t.cfg
    # by hand, first: the same first two batches (a loader of the same
    # seed), the same dropout streams, the mean gradient, one clip + AdamW
    hand = build_model(cfg, generator=torch.Generator().manual_seed(
        t.seed)).to(t.device)
    set_generators(hand, t.seed, t.device)
    hand.train()
    it = iter(build_dataloader(cfg, "train"))
    grads = []
    for _ in range(K):
        hand.zero_grad(set_to_none=True)
        total, _ = t.loss(hand(to_device(next(it), t.device)))
        total.backward()
        grads.append({n: p.grad.detach().clone()
                      for n, p in hand.named_parameters() if p.grad is not None})
    hopt = GPSOptimizer(cfg, hand, t.total_steps // K)
    for n, p in hand.named_parameters():
        if n in grads[0]:
            p.grad = (grads[0][n] + grads[1][n]) / K
    hopt.step()
    del grads

    trainable = [(n, p) for n, p in t.model.named_parameters()
                 if p.requires_grad]
    changed, first, first_grad = [], {}, {}
    inner = t.optimizer.step

    def step():
        before = [p.detach().clone() for _, p in trainable]
        stepped = inner()
        changed.append(sum(not torch.equal(b, p.detach())
                           for b, (_, p) in zip(before, trainable)))
        if stepped and not first:  # p.grad: the clipped mean AdamW took
            first.update({n: p.detach().clone() for n, p in trainable})
            first_grad.update({n: p.grad.detach().clone()
                               for n, p in trainable if p.grad is not None})
        return stepped

    t.optimizer.step = step
    rows = []
    t.logger.log = lambda row, step=None: rows.append((step, row))
    t.train_step(0)
    log(f"{tag} trainable tensors changed after each micro-step: {changed} "
        f"of {len(trainable)}; optimizer steps {t.optimizer.step_count}")
    if len(changed) != 4 or changed[0] or changed[2] or not (
            changed[1] and changed[3]):
        raise AssertionError(f"{tag} micro-steps moved {changed} tensors")
    if t.optimizer.step_count != 2:
        raise AssertionError(f"{tag} {t.optimizer.step_count} updates")
    n_upd = t.total_steps // K
    args = dict(cfg.solver.sched.args)
    floor = float(args.get("minimum_ratio", 1e-5))
    for step_i, row in rows:
        ratio = max(0.5 * (1 + math.cos(step_i / n_upd * math.pi)), floor)
        for i, (_, base) in enumerate(t.optimizer.group_info):
            got = row[f"train/lr/group_{i}"]
            if not math.isclose(got, base * ratio, rel_tol=1e-12):
                raise AssertionError(f"{tag} step {step_i} group {i}: LR "
                                     f"{got} vs {base * ratio}")
    log(f"{tag} logged LRs at steps {[s for s, _ in rows]} follow the "
        f"schedule over {n_upd} = {t.total_steps} // {K} updates")
    hp = dict(hand.named_parameters())
    worst = max(((first_grad[n] - hp[n].grad).abs().max().item()
                 / max(hp[n].grad.abs().max().item(), 1e-30), n)
                for n in first_grad)
    lrs = {id(p): g["lr"] for g in hopt.opt.param_groups for p in g["params"]}
    share, off = 0.0, None
    for n, p in hp.items():
        if n not in first:
            continue
        err = (first[n] - p.detach()).abs()
        tol = 1e-5 * first[n].abs().max() + 1e-2 * lrs.get(id(p), 0.0)
        frac = (err > tol).float().mean().item()
        if frac > share:
            share, off = frac, n
    log(f"{tag} first update vs by hand: clipped gradient max rel "
        f"{worst[0]:.3e} ({worst[1]}); parameters, largest share of a "
        f"tensor's elements off by more than 1e-5 max|p| + 1e-2 lr: "
        f"{share:.3e} ({off})")
    if not worst[0] <= ACCUM_TOL:
        raise AssertionError(f"{tag} accumulated gradient off by {worst}")
    if not share <= ACCUM_SHARE:
        raise AssertionError(f"{tag} first update: {share} of {off} off")
    return {"changed": changed, "updates": 2,
            "grad_max_rel_err_vs_hand": worst[0],
            "param_share_off_vs_hand": share}


def _means(rows, key, n):
    return [statistics.mean(r[key] for r in rows[i:i + n])
            for i in range(0, len(rows), n)]


def trainer_run():
    """VERDICT #2: ``OpenVocabTrainer`` for 32 steps with a resume at step
    16. Trainer A runs epochs 1-4 and writes ``ckpt_4.pth``; a fresh
    trainer B with ``resume=True`` must then hold A's parameters, AdamW
    moments, optimizer step and tracker bit for bit, and runs epochs 5-8.
    The loss falls and the train-side PretrainEval target metric rises
    (means of the first and last TRAINER_HALF steps); the val ScanReferEval metrics
    are printed: the synthetic val split is random and disjoint from train.
    The launch counts are set to 0 before A and read after B."""
    import shutil

    import torch

    from sceneverse_tpu_torch.ops import _build

    tag = "[trainer run]"
    exp = os.path.join(REPO, "build", "smoke_runs", "trainer", "run")
    shutil.rmtree(exp, ignore_errors=True)
    _build.reset_launches()
    t0 = time.perf_counter()
    a = _trainer("run", TRAINER_RUN)
    a.epochs = TRAINER_CUT
    a.run()
    t_a = time.perf_counter() - t0
    saved = sorted(os.listdir(a.ckpt_path))
    log(f"{tag} A: epochs 1-{TRAINER_CUT}, {a.global_step} steps in "
        f"{t_a:.1f} s (host clock, evals and saves included); checkpoints "
        f"{saved}")
    b = _trainer("run", TRAINER_RUN + ["resume=True"])
    if b.resumed_from is None or b.resumed_from.name != f"ckpt_{TRAINER_CUT}.pth":
        raise AssertionError(f"{tag} B resumed from {b.resumed_from}")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    same = [torch.equal(sa[k], sb[k]) for k in sa]
    oa, ob = a.optimizer.opt.state_dict(), b.optimizer.opt.state_dict()
    moments = [torch.equal(v, ob["state"][i][k])
               for i, st in oa["state"].items() for k, v in st.items()]
    checks = {
        "parameters": all(same) and set(sa) == set(sb),
        "adamw_state": all(moments) and oa["state"].keys() == ob["state"].keys(),
        "optimizer_step": a.optimizer.step_count == b.optimizer.step_count,
        "tracker": a.exp_tracker.state_dict() == b.exp_tracker.state_dict(),
        "global_step": (a.global_step == b.global_step
                        == TRAINER_CUT * len(a.data_loaders["train"])),
    }
    log(f"{tag} B resumed from {b.resumed_from.name}: {len(same)} state "
        f"tensors, {len(moments)} AdamW tensors, optimizer step "
        f"{b.optimizer.step_count}, tracker {b.exp_tracker.state_dict()}; "
        f"equal to A's at the save: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} resumed state differs: {checks}")
    hist_a, n_steps = a.history, b.epochs * len(b.data_loaders["train"])
    del a, sa, sb, oa, ob
    _free()
    t0 = time.perf_counter()
    b.run()
    t_b = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    rows = hist_a["train"] + b.history["train"]
    steps = [r["step"] for r in rows]
    if steps != list(range(1, n_steps + 1)):
        raise AssertionError(f"{tag} train rows at steps {steps}")
    loss = _means(rows, "total_loss", TRAINER_HALF)
    target = _means(rows, "target_metric", TRAINER_HALF)
    log(f"{tag} B: epochs {TRAINER_CUT + 1}-{b.epochs} in {t_b:.1f} s "
        f"(host clock); "
        f"launches over A and B {launches}")
    log(f"{tag} total loss, mean of each {TRAINER_HALF} steps: "
        f"{[round(x, 4) for x in loss]}")
    for key in ("target_metric", "lang_cls_acc_mask", "og_acc",
                "obj_cls_post_acc", "obj_cls_raw_acc"):
        if key in rows[0]:
            log(f"{tag} train {key}, mean of each {TRAINER_HALF} steps: "
                f"{[round(x, 4) for x in _means(rows, key, TRAINER_HALF)]}")
    for r in hist_a["val"] + b.history["val"]:
        log(f"{tag} val {json.dumps({k: round(v, 4) for k, v in r.items()})}")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"{tag} loss did not fall: {loss}")
    if not target[-1] > target[0]:
        raise AssertionError(f"{tag} train accuracy did not rise: {target}")
    for k in ("fps", "sa_group_mlp_pool", "mha_fwd", "mha_bwd"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the trainer "
                                 "path")
    val = [r["target_metric"] for r in hist_a["val"] + b.history["val"]]
    return {"launches": launches, "loss_means": loss,
            "train_target_means": target, "val_target": val,
            "seconds_a": t_a, "seconds_b": t_b}


def trainer_switches():
    """``profile.enabled=true profile.steps=3`` writes a trace holding the
    card's kernels and ends epoch 0 after 3 steps; ``debug.nans=true`` lets a
    clean step through and raises on a NaN put into the batch;
    ``eval.save=true`` writes ``results.json`` with one row per val item."""
    import torch

    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.trainer.default_trainer import PROFILE_WINDOWS

    tag = "[trainer switches]"
    out = {}
    # batches for every window the trainer may trace
    t = _trainer("profile", ["profile.enabled=true", "profile.steps=3",
                             f"data.synthetic_size={32 * 3 * PROFILE_WINDOWS}"])
    windows = profiled_epoch(t)
    path = windows[-1].path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"] for e in kernels}
    log(f"{tag} profile: {path.name}, {os.path.getsize(path)} bytes, "
        f"{len(kernels)} kernel events, e.g. "
        f"{sorted(n for n in names if 'mha' in n)[:2]}; windows "
        f"{len(windows)}")
    if t.global_step != 3 * len(windows) or not kernels:
        raise AssertionError(f"{tag} profile: {t.global_step} steps, "
                             f"{len(kernels)} kernels in {path}")
    out["profile_kernel_events"] = len(kernels)
    out["profile_windows"] = len(windows)
    del t, events, kernels
    _free()
    out["profile_k2"] = profile_k2()
    _free()

    t = _trainer("nans", ["debug.nans=true"])
    try:
        batch = to_device(next(iter(t.data_loaders["train"])), t.device)
        t.train_forward_backward(batch)
        bad = dict(batch, obj_locs=batch["obj_locs"].clone())
        bad["obj_locs"][0, 0, 0] = float("nan")
        try:
            t.train_forward_backward(bad)
        except FloatingPointError as e:
            log(f"{tag} debug.nans: a clean step went through; the NaN "
                f"raised: {e}")
            out["nans"] = str(e)
        else:
            raise AssertionError(f"{tag} debug.nans: the NaN went through")
    finally:
        torch.autograd.set_detect_anomaly(False)
    del t, batch, bad
    _free()

    t = _trainer("save", ["eval.save=true"])
    t.eval_step(0)
    path = os.path.join(t.cfg.exp_dir, "eval_results", "ScanReferEval",
                        "results.json")
    with open(path) as f:
        results = json.load(f)
    n_val = sum(len(ld.dataset) for ld in (
        t.data_loaders["val"] if isinstance(t.data_loaders["val"], list)
        else [t.data_loaders["val"]]))
    ids = sorted(r["scene_id"] for r in results)
    log(f"{tag} eval.save: {len(results)} rows for {n_val} val items, e.g. "
        f"{results[0]}")
    if ids != list(range(n_val)) or not all(
            len(r["bbox"]) == 6 for r in results):
        raise AssertionError(f"{tag} eval.save: rows {len(results)}")
    out["eval_save_rows"] = len(results)
    return out


PROFILE_K2_STEPS = 6  # chunk 1 eager, 2 captured and replayed, 3 replayed
# the kernels profile_k2 holds to their launches (utils/profiling.py)
PROFILE_K2_KERNELS = ("sv_mha_fwd_kernel", "sv_mha_bwd_", "sv_fps_kernel",
                      "sv_sa_fwd_kernel")


def profiled_epoch(t):
    """``t.train_step(0)`` under ``profile.enabled`` from an empty profile
    directory: the ``TraceWindow`` of every window the trainer traced (a
    window that traced fewer of the port's kernels than it launched is
    traced again, ``default_trainer.py``); the last must be complete and
    hold kernels."""
    import shutil
    from pathlib import Path

    shutil.rmtree(Path(t.cfg.exp_dir) / "profile", ignore_errors=True)
    t.train_step(0)
    windows = t.profile_windows
    if not windows or not windows[-1].complete or not windows[-1].kernels:
        raise AssertionError(f"profile: windows {[w.__dict__ for w in windows]}")
    return windows


def profile_k2():
    """``profile.enabled`` at ``solver.steps_per_dispatch=2`` on the frozen
    slice: the first PROFILE_K2_STEPS steps of epoch 0 under
    ``utils/profiling.py::trace`` (an eager chunk, the chunk that captures
    the graph, a replay), which writes one Chrome trace; its
    PROFILE_K2_KERNELS events must be exactly the launches the wrappers and
    replays counted in that window, and the run ends epoch 0 there. A
    window the installed torch.profiler leaves incomplete is traced again
    over the next steps (``default_trainer.py``); then the last window is
    held to its own launches."""
    from sceneverse_tpu_torch.trainer.default_trainer import PROFILE_WINDOWS

    tag = "[trainer switches] profile K=2"
    t = _trainer("profile_k2", [
        "profile.enabled=true", f"profile.steps={PROFILE_K2_STEPS}",
        "solver.steps_per_dispatch=2",
        f"data.synthetic_size={32 * PROFILE_K2_STEPS * PROFILE_WINDOWS}"])
    windows = profiled_epoch(t)
    window = windows[-1]
    n_graphs = sum(g is not None for g in t._graphs.values())
    if (t.global_step != PROFILE_K2_STEPS * len(windows) or n_graphs != 1):
        raise AssertionError(f"{tag}: {t.global_step} steps, {n_graphs} "
                             f"graphs, {len(windows)} windows")
    traced = {k: window.traced[k] for k in PROFILE_K2_KERNELS}
    want = {k: window.expected[k] for k in PROFILE_K2_KERNELS}
    log(f"{tag}: {window.path.name}, {window.kernels} kernel events; traced "
        f"{traced}, launched {want}, graphs {n_graphs}, windows "
        f"{len(windows)}")
    if traced != want or not all(want.values()):
        raise AssertionError(f"{tag}: traced {traced}, launched {want}")
    return {"launches": dict(window.launches), "traced": traced,
            "kernel_events": window.kernels, "windows": len(windows)}


# --------------------------------------------------------------- data phase
# the on-disk tree of the data phase (the port's fixture writer): one scan of
# 90 objects (63 foreground: 17 of a scene's 80 slots are pads, and the
# target-first crop to max_obj_len - 1 = 79 does not run) of 1200 points
# each (subsampled to 1024); about 2,500 train items over all_pretrain's
# five families' sources
DATA_TREE = {"n_scans": 1, "n_objects": 90, "pts_per_obj": 1200}
DATA_ROOTS = ("scan_family_base", "rscan_base", "arkitscene_base",
              "multiscan_base", "hm_base")
# launches of the frozen path: per forward (train step or eval batch) SA1
# and SA2 each one fps and one sa_group_mlp_pool, 15 fused attention layers;
# per train step 15 mha_bwd
DATA_PER_FORWARD = {"fps": 2, "sa_group_mlp_pool": 2, "mha_fwd": 15}
DATA_PER_STEP = {"mha_bwd": 15}
# batches ``loader_rates`` times after a loader's first (without workers;
# with 4 workers, more than their 8 prefetched batches)
LOADER_BATCHES = {"workers_0": 3, "workers_4": 16}
# train steps of the run through the materialized store
MATERIALIZED_STEPS = 6


@contextlib.contextmanager
def eval_loaders_in_process():
    """The trainer's val and test loaders built with
    ``dataloader.num_workers=0``, its train loader as configured: a
    spawned 4-worker loader takes 30-45 s to start on the card's host, and
    the data run's val and test splits are one batch each (for the smoke's
    time budget, as FT_REDUCED does for the finetune runs)."""
    import copy

    from sceneverse_tpu_torch.trainer import build as trainer_build

    real = trainer_build.build_dataloader

    def build(cfg, split="train"):
        if split != "train":
            cfg = copy.deepcopy(cfg)
            cfg.dataloader.num_workers = 0
        return real(cfg, split)

    trainer_build.build_dataloader = build
    try:
        yield
    finally:
        trainer_build.build_dataloader = real


def data_args(root, extra=()):
    """``run_torch`` arguments of ``configs/final/all_pretrain.yaml`` as it
    stands, with only the data roots, one card, ground-truth objects (the
    tree has no Mask3D files), one epoch and a fetch per step set."""
    return ["--config-path", os.path.join(REPO, "configs", "final"),
            "--config-name", "all_pretrain",
            *[f"data.{k}={root}" for k in DATA_ROOTS], "num_gpu=1",
            "data.args.pc_type=gt", "solver.epochs=1", "solver.log_every=1",
            *extra]


def loader_rates(root, loader):
    """Scenes/s of the train loader alone (no model), host clock from a
    batch's arrival to the last one's: ``loader``, the data run's own
    DataLoader (its 4 spawned workers already started), over
    LOADER_BATCHES["workers_4"] batches of a new epoch after its first,
    which it returns too; the DataLoader at 0 workers over
    LOADER_BATCHES["workers_0"] batches; the materialized batch loader over
    an epoch."""
    import run_torch
    from sceneverse_tpu_torch.data import build_dataloader
    from sceneverse_tpu_torch.data.materialized import \
        build_materialized_train_loader

    stages = {}

    def rate(name, build, n):
        t0 = time.perf_counter()
        loader = build()
        it = iter(loader)
        first = next(it)
        t1 = time.perf_counter()
        for _ in range(n(loader)):
            next(it)
        t2 = time.perf_counter()
        # a loader with workers is drained untimed: a worker shut down
        # while its batches in shared memory wait unread aborts (torch's,
        # not this code's); one without has nothing in flight
        if getattr(loader, "num_workers", 0):
            for _ in it:
                pass
        stages[name] = {"to_first_s": t1 - t0, "timed_s": t2 - t1,
                        "drain_s": time.perf_counter() - t2}
        return n(loader) * batch / (t2 - t1), first

    def cfg(*extra):
        return run_torch.load_cfg(data_args(root, list(extra)))

    batch = int(cfg().dataloader.batchsize)
    out = {}
    out["workers_4"], first = rate(
        "workers_4", lambda: loader,
        lambda ld: min(LOADER_BATCHES["workers_4"], len(ld) - 1))
    out["workers_0"] = rate(
        "workers_0",
        lambda: build_dataloader(cfg("dataloader.num_workers=0"), "train"),
        lambda ld: min(LOADER_BATCHES["workers_0"], len(ld) - 1))[0]
    out["materialized"] = rate(
        "materialized",
        lambda: build_materialized_train_loader(
            cfg("data.args.materialized=fast")), lambda ld: len(ld) - 1)[0]
    log(f"[data] loader stages, host clock s (build and first batch, timed "
        f"batches, the rest drained): {stages}")
    return out, first


class FirstBatches:
    """The first ``n`` batches of each epoch of ``loader``: a generator
    without workers, such as the materialized batch loader, left
    unfinished holds nothing."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, min(n, len(loader))

    def __len__(self):
        return self.n

    def __iter__(self):
        it = iter(self.loader)
        return (next(it) for _ in range(self.n))


def eval_loaders(trainer, split):
    loaders = trainer.data_loaders[split]
    return loaders if isinstance(loaders, list) else [loaders]


@contextlib.contextmanager
def eager_eval(trainer):
    """The val evaluators on the eager loop (``update`` per batch), whose
    ``trainer.forward`` an oracle may replace: the fused eval replays the
    graphs of the model's own forward."""
    evs = trainer._val_evaluator()
    evs = list({id(e): e for e in (evs if isinstance(evs, list)
                                   else [evs])}.values())
    for ev in evs:
        ev.JIT_METRICS = False
    try:
        yield
    finally:
        for ev in evs:
            del ev.JIT_METRICS


def check_eval(tag, trainer):
    """What the trained model picks on the val split, and the evaluator on
    oracle logits. First the model's forward over the val loader: how often
    the og3d argmax lands on a pad object (the model leaves pad objects'
    og3d logits unmasked, as the JAX package's does), og accuracy with pad
    objects masked, and the share of real objects whose predicted class
    (raw and post) is one of the batch's labels. Then ``_eval_loop`` on
    the same loader with the model's forward replaced by oracle logits (the
    target's og3d logit 1, every object's class logit at its label 1): every
    ``ScanReferEval`` metric must be 1 (the unique / multiple ones 0 where
    the split holds no such item), so a wrong id, label or box read fails
    it."""
    import torch

    from sceneverse_tpu_torch.trainer.build import to_device

    n = on_pad = hit = hit_masked = n_mult = 0
    cls_in = {"obj_cls_raw": 0, "obj_cls_post": 0}
    n_obj = 0
    n_cls = None
    for loader in eval_loaders(trainer, "val"):
        for host in loader:
            b = to_device(host, trainer.device)
            out = trainer.forward(b)
            m = b["obj_masks"].bool()
            og = out["og3d_logits"].float()
            tgt = b["tgt_object_id"][:, 0]
            pred = og.argmax(-1)
            rows = torch.arange(len(pred), device=pred.device)
            on_pad += int((~m[rows, pred]).sum())
            hit += int((pred == tgt).sum())
            masked = og.masked_fill(~m, float("-inf")).argmax(-1)
            hit_masked += int((masked == tgt).sum())
            n += len(pred)
            n_mult += int(b["is_multiple"].bool().sum())
            labels = b["obj_labels"][m]
            present = torch.unique(labels)
            for key in cls_in:
                p = out[f"{key}_logits"].argmax(-1)[m]
                cls_in[key] += int(torch.isin(p, present).sum())
            n_obj += int(m.sum())
            n_cls = out["obj_cls_raw_logits"].shape[-1]
    diag = {"items": n, "og_argmax_on_pad": on_pad / n, "og_acc": hit / n,
            "og_acc_pads_masked": hit_masked / n,
            **{f"{k}_pred_among_labels": v / n_obj
               for k, v in cls_in.items()}}
    log(f"{tag} the model on val: {diag}")

    def oracle(batch):
        m = batch["obj_masks"].bool()
        B, O = m.shape
        og = torch.zeros((B, O), device=m.device)
        og[torch.arange(B, device=m.device), batch["tgt_object_id"][:, 0]] = 1
        labels = batch["obj_labels"].long().clamp_min(0)
        cls = torch.nn.functional.one_hot(labels, n_cls).float()
        return {"og3d_logits": og, "obj_cls_raw_logits": cls,
                "obj_cls_post_logits": cls}

    # the run's metrics log is closed: the oracle pass writes no row
    trainer.forward, trainer.log = oracle, lambda *a, **k: None
    try:
        with eager_eval(trainer):
            res = trainer._eval_loop("val", "val")[1]
    finally:
        del trainer.forward, trainer.log
    want = {k: 1.0 for k in res if k not in ("target_metric", "best_result")}
    for kind, count in (("unique", n - n_mult), ("multiple", n_mult)):
        for iou in ("25", "50"):
            want[f"og_acc_iou{iou}_{kind}"] = 1.0 if count else 0.0
    got = {k: float(res[k]) for k in want}
    log(f"{tag} val metrics on oracle logits: {got}")
    if got != want or "og_acc" not in got:
        raise AssertionError(f"{tag} oracle val metrics {got}, expected "
                             f"{want}")
    return {**diag, "oracle": got}


def _run_data(name, root, extra, steps=None):
    """``run_torch.main`` on all_pretrain over the tree (with ``steps``,
    what it does with the train loader cut to its first ``steps`` batches):
    every loss finite, each kernel of the frozen path launched exactly as
    often per train step and per eval batch as that path needs and no other
    kernel, val and test ``ScanReferEval`` metrics in [0, 1], then
    ``check_eval``."""
    import torch

    import run_torch
    from sceneverse_tpu_torch.ckpt.checkpoint import wait_for_checkpoints
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.trainer.build import build_trainer

    tag = f"[data {name}]"
    args = data_args(root, extra + [
        f"base_dir={os.path.join(REPO, 'build', 'smoke_runs', name)}"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t_start = time.time()  # the metrics log's clock
    t0 = time.perf_counter()
    if steps is None:
        trainer = run_torch.main(args)["trainer"]
    else:
        cfg = run_torch.load_cfg(args)
        os.makedirs(cfg.exp_dir, exist_ok=True)
        trainer = build_trainer(cfg)
        trainer.data_loaders["train"] = FirstBatches(
            trainer.data_loaders["train"], steps)
        trainer.run()
        wait_for_checkpoints()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    hist = trainer.history
    n_train = len(hist["train"])
    n_eval = sum(len(trainer.data_loaders[s]) for s in ("val", "test"))
    losses = [r["total_loss"] for r in hist["train"]]
    steady = statistics.mean(r["step_s"] for r in hist["train"][1:])
    batch = int(trainer.cfg.dataloader.batchsize)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} {n_train} train steps at batch {batch} and {n_eval} eval "
        f"batches in {wall:.1f} s (host clock, loader starts and saves "
        f"included); steady step {steady:.4f} s (mean after the first, "
        f"batch on the card to losses fetched) -> {batch / steady:.2f} "
        f"scenes/s; peak memory {peak:.2f} GiB")
    log(f"{tag} total loss per step: {[round(x, 4) for x in losses]}")
    log(f"{tag} launches {launches}")
    for key in ("val", "test"):
        log(f"{tag} {key} {hist[key]}")
    if n_train < 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} losses not finite / too few: {losses}")
    want = {k: n * (n_train + n_eval) for k, n in DATA_PER_FORWARD.items()}
    want.update({k: n * n_train for k, n in DATA_PER_STEP.items()})
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want} "
                             f"({n_train} train steps, {n_eval} eval "
                             "batches)")
    for key in ("val", "test"):
        res = hist[key][-1] if hist[key] else {}
        bad = {k: v for k, v in res.items()
               if k != "best_result" and not 0.0 <= v <= 1.0}
        if not res or bad:
            raise AssertionError(f"{tag} {key} metrics {res}")
    # the train loop's host clock per step, loader waits included: the
    # metrics log's row times (one row per step, written at its fetch; the
    # val and test rows at the end of their passes)
    with open(os.path.join(trainer.cfg.exp_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ts = [r["_ts"] for r in rows if "train/total_loss" in r]
    t_val, t_test = (next(r["_ts"] for r in rows if f"{k}/og_acc" in r)
                     for k in ("val", "test"))
    loop_step = (ts[-1] - ts[0]) / (len(ts) - 1)
    starts = {"to_first_fetch_s": ts[0] - t_start,
              "val_pass_s": t_val - ts[-1], "test_pass_s": t_test - t_val}
    log(f"{tag} train loop {loop_step:.4f} s a step (host clock between the "
        f"steps' fetches, loader waits included) -> {batch / loop_step:.2f} "
        f"scenes/s; host clock s: run start to the first step's fetch (the "
        f"trainer's build, the train loader's start, one step), the val "
        f"pass and the test pass (each starts its loader; the epoch's saves "
        f"before the test pass): {starts}")
    info = {"exp_dir": trainer.cfg.exp_dir,
            "train_steps": n_train, "eval_batches": n_eval, "batch": batch,
            "losses": losses, "steady_step_s": steady,
            "scenes_per_s": batch / steady, "loop_step_s": loop_step,
            "loop_scenes_per_s": batch / loop_step, "wall_s": wall,
            **starts,
            "peak_mem_gib": peak, "launches": launches,
            "val": hist["val"][-1], "test": hist["test"][-1]}
    # after the run's rows are read: the oracle pass adds a val row
    info["eval_check"] = check_eval(tag, trainer)
    return info, trainer


def sa_on_batch(table, obj_fts, pnet, label):
    """``fps`` and ``sa_group_mlp_pool`` of SA1 and SA2 on one batch's
    objects (G = B x O, pad objects included) with the model's frozen
    weights, each level fed the kernels' output of the one before, as the
    frozen PointNet++ runs: ``fps`` bit-equal to its twin and over two runs,
    ``sa_group_mlp_pool`` within SA_TOL of its twin and bit-identical over
    two runs; each row with its in-ball pair share and its device time."""
    import torch

    from sceneverse_tpu_torch.ops import sa_forward as sa

    pts = obj_fts.reshape(-1, *obj_fts.shape[2:]).float().cuda()
    G = pts.shape[0]
    rows = []
    for li, level in enumerate(pnet.encoder[:2]):
        m, ns, r = level.npoint, level.nsample, level.radius
        N, C = pts.shape[1:]
        tag = f"SA{li + 1} {label} G={G} N={N} C={C} m={m}"
        xyz = pts[..., :3].contiguous()
        got_xyz, got_idx = sa.fps(xyz, m)
        want_xyz, want_idx = sa.fps_plain(xyz, m)
        if not (torch.equal(got_idx, want_idx)
                and torch.equal(got_xyz, want_xyz)
                and torch.equal(sa.fps(xyz, m)[1], got_idx)):
            raise AssertionError(f"fps {tag}: differs from its twin or "
                                 "between two runs")
        fps_dev = device_ms(lambda: sa.fps(xyz, m), "sv_fps_kernel")
        rows.append({"kernel": "fps", "shape": tag, "device_ms": fps_dev})
        table.add("fps", tag, "f32", *_err(got_xyz, want_xyz),
                  cuda_ms(lambda: sa.fps(xyz, m)),
                  cuda_ms(lambda: sa.fps_plain(xyz, m)), 0.0,
                  fps_bound(G, N, m), device_ms=fps_dev)
        ws = [t for pair in sa.fold_shared_mlp(level.mlps[0]) for t in pair]
        ops = sa.prepare_weights(*[w.detach().float().cuda() for w in ws])
        spec = [C] + [w.shape[0] for w in ws[0::2]]
        got = check_sa_fwd(table, "sa_group_mlp_pool", tag,
                           sa.sa_group_mlp_pool, sa.sa_group_mlp_pool_plain,
                           pts, got_xyz, ops, r, ns, spec, {"nsample": ns})
        shape = table.rows["sa_group_mlp_pool"]["shapes"][-1]
        shape["device_ms"] = device_ms(
            lambda: sa.sa_group_mlp_pool(pts, got_xyz, *ops, radius=r,
                                         nsample=ns), "sv_sa_fwd_kernel")
        rows.append({"kernel": "sa_group_mlp_pool", "shape": tag,
                     "in_ball": shape["in_ball"],
                     "device_ms": shape["device_ms"]})
        log(f"[kernels on a batch] {tag}: in-ball pair share "
            f"{shape['in_ball']:.4f}, device fps {fps_dev:.4f} ms, "
            f"sa_group_mlp_pool {shape['device_ms']:.4f} ms")
        pts = torch.cat([got_xyz, got], -1).contiguous()
    return rows


def mha_on_batch(table, trainer, batch, source="pipeline"):
    """``mha_fwd`` and ``mha_bwd`` against their twins on the operands the
    model hands them in one train step on a pipeline batch: the batch's own
    text and object padding, the 'cond' gate on its object locations, the
    layers' dropout seeds. The step's backward calls are recorded (each
    carries its forward's operands and the incoming gradient) and the first
    of each distinct shape, gate and dropout goes through ``check_mha``."""
    from sceneverse_tpu_torch.ops import mha

    calls = []
    real = mha.mha_bwd

    def record(*args):
        calls.append(args)
        return real(*args)

    mha.mha_bwd = record
    try:
        trainer.train_forward_backward(batch)
    finally:
        mha.mha_bwd = real
    seen = {}
    for q, k, v, pad, sw, locs, do, _, _, H, scale, rate, seed in calls:
        key = (tuple(q.shape), k.shape[1], sw is not None, rate, q.dtype)
        seen.setdefault(key, (q, k, v, pad, sw, locs, do, H, scale, rate,
                              seed))
    rows = []
    for (shape, T, gate, rate, dtype), args in seen.items():
        B, L, D = shape
        label = (f"{source} B={B} L={L}{' cond' if gate else ''}"
                 f"{f' drop{rate:g}' if rate else ''}")
        dname = "bf16" if "bfloat16" in str(dtype) else "f32"
        check_mha(table, label, dname, *args)
        rows.append(label)
    log(f"[{source} kernels] mha_fwd / mha_bwd on the batch's "
        f"{len(calls)} attention calls, {len(rows)} distinct: {rows}")
    return rows


def phase_data(table):
    """configs/final/all_pretrain.yaml end to end from an on-disk tree the
    port's fixture writer makes: the run through DataLoader workers, the
    run through the materialized store, the frozen SA kernels against their
    twins on a train batch of the pipeline (and on standard-normal objects,
    the synthetic slices' input, for comparison), and the host loader's
    rates."""
    import shutil

    import torch

    import run_torch
    from sceneverse_tpu_torch.data import get_dataset
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree
    from sceneverse_tpu_torch.data.materialized import ensure_materialized
    from sceneverse_tpu_torch.data.tokenizer import _CACHED, get_tokenizer
    from sceneverse_tpu_torch.trainer.build import to_device

    root = os.path.join(REPO, "build", "smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    t_phase = t0 = time.perf_counter()
    write_synthetic_tree(root, **DATA_TREE)
    cfg = run_torch.load_cfg(data_args(root))
    n_items = {s: [len(d) for d in (ds.datasets if s == "train" else ds)]
               for s in ("train", "val")
               for ds in [get_dataset(cfg, s)]}
    tok = get_tokenizer(cfg)
    vocab = next(k for k, v in _CACHED.items() if v is tok)
    log(f"[data] tree {DATA_TREE} written in {time.perf_counter() - t0:.1f} "
        f"s; items per family: train {n_items['train']} (total "
        f"{sum(n_items['train'])}), val {n_items['val']}; tokenizer "
        f"{'hash' if vocab == '__hash__' else vocab}")
    out = {"tree": DATA_TREE, "items": n_items, "tokenizer": vocab,
           "cpu_count": os.cpu_count()}
    with eval_loaders_in_process():
        out["run"], trainer = _run_data("data", root, [])
    pnet = trainer.model.point_encoder.point_feature_extractor
    t0 = time.perf_counter()
    stores = {f"{n}_{s}": str(ensure_materialized(cfg, n, s))
              for s in ("train", "val") for n in cfg.data[s]}
    out["store_s"] = time.perf_counter() - t0
    log(f"[data] materialized stores built in {out['store_s']:.1f} s: "
        f"{sorted(stores)}")
    out["loader_scenes_per_s"], batch = loader_rates(
        root, trainer.data_loaders["train"])
    log(f"[data] train loader alone, scenes/s (host clock, "
        f"os.cpu_count() = {os.cpu_count()}): {out['loader_scenes_per_s']}")
    dev = to_device(batch, trainer.device)
    out["kernels"] = {"mha": mha_on_batch(table, trainer, dev)}
    # one train step's device time on that batch (kernels, copies, fills),
    # against the runs' host-clock steps: the device's busy share
    step_ms, events = kernel_sum_ms(lambda: trainer.train_forward_backward(
        dev))
    out["device_step_ms"] = step_ms

    def busy(run):
        return {"step": step_ms / 1e3 / run["steady_step_s"],
                "loop": step_ms / 1e3 / run["loop_step_s"]}

    out["busy"] = {"run": busy(out["run"])}
    del trainer, dev
    _free()
    # the pipeline's own batch (the first of the run's loader's second
    # epoch) through SA1 and SA2, then standard-normal objects
    fts = torch.as_tensor(batch["obj_fts"])
    pad = ~torch.as_tensor(batch["obj_masks"])
    log(f"[data kernels] train batch obj_fts {tuple(fts.shape)}, "
        f"{int(pad.sum())} pad objects (every point 1.0: "
        f"{bool((fts[pad] == 1.0).all())})")
    g = torch.Generator().manual_seed(0)
    out["kernels"].update({
        "pipeline": sa_on_batch(table, fts, pnet, "pipeline"),
        "synthetic": sa_on_batch(table, torch.randn(fts.shape, generator=g),
                                 pnet, "standard-normal")})
    del pnet, batch, fts
    _free()
    out["materialized"], trainer = _run_data(
        "data_materialized", root, ["data.args.materialized=fast",
                                    "dataloader.num_workers=0"],
        steps=MATERIALIZED_STEPS)
    del trainer
    _free()
    out["busy"]["materialized"] = busy(out["materialized"])
    log(f"[data] one train step at batch 64: {step_ms:.2f} ms of device "
        f"work ({events} events, torch.profiler); busy share of the step "
        f"(batch on the card to losses fetched) and of the train loop: "
        f"{out['busy']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[data] phase took {out['seconds']:.1f} s")
    return out


# the finetune phase's tree (the port's fixture writer): 5 scans of 120
# objects (84 foreground: the crop to max_obj_len - 1 = 79 runs, one pad
# slot a scene) x 1200 points (subsampled to 1024), 3 referring
# annotations per foreground object; scans 0-3 in the train split, scan 4
# in val and test (the phase rewrites the split files): 1008 ScanRefer
# train items (3 steps at batch 256), 252 val and 252 test; its own QA
# files, whose answer vocabularies have the configs' published sizes
FT_TREE = {"n_scans": 5, "n_objects": 120, "pts_per_obj": 1200,
           "annos_per_obj": 3}
FT_TRAIN_SCANS = 4
FT_QA_ITEMS = {"train": 160, "val": 64, "test": 64}
FT_ANSWERS = {"scanqa": 8864, "sqa3d": 706}
# answers the QA items draw from (every val item's is in the train
# vocabulary); the rest of a vocabulary is fillers the train items carry
FT_COMMON = 20
# run: (config under configs/final/finetune, its target metric, its head)
FT_RUNS = {
    "scanrefer": ("scanrefer_finetune", "og_acc_iou25", "ground_head"),
    "scanqa": ("scanqa_finetune", "ans1_acc", "qa_head"),
    "nr3d": ("nr3d_finetune", "og_acc", "ground_head"),
    "sqa3d": ("sqa3d_finetune", "ans1_acc", "qa_head"),
}
# launches of the finetune path (no scene caption): per forward SA1 and SA2
# each one fps and one sa_group_mlp_pool, 12 fused attention layers
# (utterance BERT 4, spatial 4, unified 4); per train step 12 mha_bwd
FT_PER_FORWARD = {"fps": 2, "sa_group_mlp_pool": 2, "mha_fwd": 12}
FT_PER_STEP = {"mha_bwd": 12}
# the one override beyond the contract's: each spawned 4-worker loader
# takes 30-35 s to start on the card's host (three starts a run, twelve in
# the phase), so the runs load in the main process
FT_REDUCED = ["dataloader.num_workers=0"]
# each run's train loader cut to its first FT_STEPS batches (Nr3D's epoch
# is 7 batches of 256, about 9 s each at 0 workers), for the smoke's time
# budget
FT_STEPS = 2


def write_finetune_tree(root):
    """The fixture tree of FT_TREE, its split files cut to FT_TRAIN_SCANS
    train scans and one held-out val / test scan, and QA files of
    FT_QA_ITEMS items: ScanQA train items answer one of FT_COMMON answers
    plus their share of fillers, so the train json's vocabulary has
    FT_ANSWERS["scanqa"] answers; SQA3D's ``answer_dict.json`` has
    FT_ANSWERS["sqa3d"] (``u`` included) and its questions start with each
    of the six question types' words. Returns the scan ids by split."""
    from sceneverse_tpu_torch.data.fixture import (CATEGORIES,
                                                   write_synthetic_tree)

    write_synthetic_tree(root, **FT_TREE)
    scans = [f"scene{i:04d}_00" for i in range(FT_TREE["n_scans"])]
    ids = {"train": scans[:FT_TRAIN_SCANS], "val": scans[FT_TRAIN_SCANS:]}
    ids["test"] = ids["val"]
    ann = os.path.join(root, "annotations")
    for split in ("train", "val", "test"):
        with open(os.path.join(ann, "splits", f"scannetv2_{split}.txt"),
                  "w") as f:
            f.write("\n".join(ids[split]) + "\n")
    fg = [i for i in range(FT_TREE["n_objects"])
          if CATEGORIES[i % len(CATEGORIES)] not in ("wall", "floor",
                                                     "ceiling")]
    common = [f"answer {k}" for k in range(FT_COMMON)]
    fillers = [f"filler answer {k}"
               for k in range(FT_ANSWERS["scanqa"] - FT_COMMON)]
    n_train = FT_QA_ITEMS["train"]

    def items(split):
        for i in range(FT_QA_ITEMS[split]):
            obj = fg[(7 * i) % len(fg)]
            yield (i, ids[split][i % len(ids[split])], obj,
                   CATEGORIES[obj % len(CATEGORIES)])

    for split, fname in (("train", "train"), ("val", "val"),
                         ("test", "test_w_obj")):
        rows = []
        for i, scan, obj, name in items(split):
            row = {"scene_id": scan, "question_id": f"{split}-{i}",
                   "question": f"What is next to the {name} number {i}?",
                   "object_ids": [obj], "object_names": [name]}
            if split == "train":
                row["answers"] = [common[i % FT_COMMON]] + fillers[i::n_train]
            elif split == "val":  # test_w_obj carries no answers
                row["answers"] = [common[(3 * i) % FT_COMMON]]
            rows.append(row)
        with open(os.path.join(ann, "qa", f"ScanQA_v1.0_{fname}.json"),
                  "w") as f:
            json.dump(rows, f)
    sqa = common + [f"situated answer {k}" for k in
                    range(FT_ANSWERS["sqa3d"] - FT_COMMON - 1)] + ["u"]
    with open(os.path.join(ann, "sqa_task", "answer_dict.json"), "w") as f:
        json.dump([{a: k for k, a in enumerate(sqa)}, {}], f)
    words = ("What", "Is", "How", "Can", "Which", "Where")
    for split, src in (("train", "train"), ("test", "val")):
        annos, questions = [], []
        for i, scan, obj, name in items(src):
            qid = 1000 + i
            annos.append({
                "scene_id": scan, "question_id": qid,
                "answers": [{"answer": common[(3 * i) % FT_COMMON],
                             "answer_confidence": "yes", "answer_id": 1}],
                "position": {"x": 0.0, "y": 0.0, "z": 0.0},
                "rotation": {"_x": 0, "_y": 0, "_z": 0, "_w": 1}})
            questions.append({
                "scene_id": scan, "question_id": qid,
                "situation": f"I am standing by the {name}.",
                "alternative_situation": ["I just sat on the sofa."],
                "question": f"{words[i % len(words)]} is next to the {name}?"})
        base = os.path.join(ann, "sqa_task", "balanced")
        with open(os.path.join(base, "v1_balanced_sqa_annotations_"
                               f"{split}_scannetv2.json"), "w") as f:
            json.dump({"annotations": annos}, f)
        with open(os.path.join(base, "v1_balanced_questions_"
                               f"{split}_scannetv2.json"), "w") as f:
            json.dump({"questions": questions}, f)
    return ids


def finetune_args(name, root, ckpt, extra=()):
    """``run_torch`` arguments of the run's config as it stands, with only
    the data root, one card, ground-truth objects (the tree has no Mask3D
    files; ``scanqa_finetune.yaml`` inherits ``pred``), one epoch, a fetch
    per step, the pretrain checkpoint and FT_REDUCED set."""
    return ["--config-path", os.path.join(REPO, "configs", "final",
                                          "finetune"),
            "--config-name", FT_RUNS[name][0],
            f"data.scan_family_base={root}", "num_gpu=1",
            "data.args.pc_type=gt", "solver.epochs=1", "solver.log_every=1",
            f"pretrain_ckpt_path={ckpt}", *FT_REDUCED,
            f"base_dir={os.path.join(REPO, 'build', 'smoke_runs', 'finetune', name)}",
            *extra]


def check_finetune_eval(tag, trainer, head):
    """One pass over the val split with the model's forward wrapped: the
    model's own outputs are read (the og3d argmax must never land on a pad
    object, which the ground head masks to -inf; how often the model is
    right), then the evaluator gets oracle outputs instead (the target's
    og3d logit 1, each object's and the text's class logit at its label 1,
    an answer of the item's at score 1). Every metric must be 1, or 0
    where its split holds no item: a wrong id, label, answer or type read
    fails it."""
    import torch
    import torch.nn.functional as F

    real = trainer.forward
    seen = {"items": 0, "right": 0, "argmax_on_pad": 0, "answered": 0,
            "is_multiple": 0, "is_hard": 0, "is_view_dependent": 0,
            **{f"type{t}": 0 for t in range(6)}}

    def oracle(batch):
        out = real(batch)
        m = batch["obj_masks"].bool()
        B = m.shape[0]
        rows = torch.arange(B, device=m.device)
        labels = batch["obj_labels"].long().clamp_min(0)
        cls = F.one_hot(labels, out["obj_cls_raw_logits"].shape[-1]).float()
        res = {"obj_cls_raw_logits": cls}
        seen["items"] += B
        if head == "ground_head":
            tgt = batch["tgt_object_id"][:, 0]
            pred = out["og3d_logits"].argmax(-1)
            seen["argmax_on_pad"] += int((~m[rows, pred]).sum())
            seen["right"] += int((pred == tgt).sum())
            for k in ("is_multiple", "is_hard", "is_view_dependent"):
                if k in batch:
                    seen[k] += int(batch[k].bool().sum())
            og = torch.zeros(m.shape, device=m.device)
            og[rows, tgt] = 1.0
            res.update(og3d_logits=og, obj_cls_post_logits=cls,
                       obj_cls_pre_logits=cls, txt_cls_logits=F.one_hot(
                           batch["tgt_object_label"][:, 0],
                           out["txt_cls_logits"].shape[-1]).float())
        else:
            lab = batch["answer_label"]
            pred = out["answer_scores"].argmax(-1)
            seen["right"] += int((lab[rows, pred] == 1).sum())
            seen["answered"] += int(lab.any(-1).sum())
            if "sqa_type" in batch:
                for t in range(6):
                    seen[f"type{t}"] += int((batch["sqa_type"] == t).sum())
            res["answer_scores"] = F.one_hot(lab.argmax(-1),
                                             lab.shape[1]).float()
        return res

    # the run's metrics log is closed: the oracle pass writes no row
    trainer.forward, trainer.log = oracle, lambda *a, **k: None
    try:
        with eager_eval(trainer):
            res = trainer._eval_loop("val", "val")[1]
    finally:
        del trainer.forward, trainer.log
    n = seen["items"]
    want = {k: 1.0 for k in res if k not in ("target_metric", "best_result")}
    split_counts = {
        "og_acc_iou25_unique": n - seen["is_multiple"],
        "og_acc_iou50_unique": n - seen["is_multiple"],
        "og_acc_iou25_multiple": seen["is_multiple"],
        "og_acc_iou50_multiple": seen["is_multiple"],
        "og_acc_easy": n - seen["is_hard"], "og_acc_hard": seen["is_hard"],
        "og_acc_view_dep": seen["is_view_dependent"],
        "og_acc_view_indep": n - seen["is_view_dependent"],
        **{f"type{t}_acc": seen[f"type{t}"] for t in range(6)}}
    for k, count in split_counts.items():
        if k in want:
            want[k] = 1.0 if count else 0.0
    got = {k: float(res[k]) for k in want}
    diag = {"items": n, "model_right": seen["right"] / n}
    if head == "ground_head":
        diag["og_argmax_on_pad"] = seen["argmax_on_pad"] / n
    log(f"{tag} the model on val: {diag}; val metrics on oracle outputs: "
        f"{got}")
    if head == "qa_head" and seen["answered"] != n:
        raise AssertionError(f"{tag} {n - seen['answered']} val items have "
                             "no answer in the train vocabulary")
    if head == "ground_head" and seen["argmax_on_pad"]:
        raise AssertionError(f"{tag} the og3d argmax lands on a pad object "
                             f"{seen['argmax_on_pad']} times")
    if got != want:
        raise AssertionError(f"{tag} oracle val metrics {got}, expected "
                             f"{want}")
    return {**diag, "oracle": got}


def _run_finetune(name, root, ckpt, ckpt_shapes, extra=()):
    """``run_torch.main`` on one finetune config over the tree from the
    pretrain checkpoint: the checkpoint's towers all loaded (its
    ``pretrain_head.*`` left over, the new head's tensors missing, as JAX's
    ``apply_to_model`` lists them; the frozen PointNet++ equal to the
    checkpoint's after the run), every loss finite and the total moving,
    each kernel of the path launched exactly as often per train step and
    per eval batch as it needs and no other kernel, val and test metrics in
    [0, 1] with the target metric (and ``txt_acc`` for a ground head, the
    six type accuracies for SQA3D), then ``check_finetune_eval``."""
    import torch

    import run_torch
    from sceneverse_tpu_torch.ops import _build

    from sceneverse_tpu_torch.trainer import build as tbuild

    config, target, head = FT_RUNS[name]
    tag = f"[finetune {name}]"
    build_trainer = tbuild.build_trainer

    def first_steps(cfg, device=None):
        t = build_trainer(cfg, device=device)
        t.data_loaders["train"] = FirstBatches(t.data_loaders["train"],
                                               FT_STEPS)
        return t

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    tbuild.build_trainer = first_steps
    try:
        trainer = run_torch.main(finetune_args(name, root, ckpt, extra))[
            "trainer"]
    finally:
        tbuild.build_trainer = build_trainer
    wall = time.perf_counter() - t0
    trainer.data_loaders["train"] = trainer.data_loaders["train"].loader
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = trainer.history
    n_train = len(hist["train"])
    n_eval = sum(len(ld) for s in ("val", "test") if hist[s]
                 for ld in eval_loaders(trainer, s))
    batch = int(trainer.cfg.dataloader.batchsize)
    losses = [r["total_loss"] for r in hist["train"]]
    steady = statistics.mean(r["step_s"] for r in hist["train"][1:])
    own = trainer.model.state_dict()
    unexpected = sorted(k for k in ckpt_shapes if k not in own)
    missing = sorted(k for k in own if k not in ckpt_shapes)
    mismatched = [k for k in ckpt_shapes if k in own
                  and tuple(own[k].shape) != ckpt_shapes[k]]
    log(f"{tag} {config}: {n_train} train steps at batch {batch} and "
        f"{n_eval} eval batches in {wall:.1f} s (host clock, the build and "
        f"saves included); steady step {steady:.4f} s (mean after the "
        f"first, batch on the card to losses fetched); peak memory "
        f"{peak:.2f} GiB; {trainer.pretrain_loaded} tensors loaded, "
        f"{len(missing)} missing (e.g. {missing[:3]}), {len(unexpected)} "
        f"unexpected (e.g. {unexpected[:3]})")
    log(f"{tag} total loss per step: {losses}")
    log(f"{tag} launches {launches}")
    for key in ("val", "test"):
        log(f"{tag} {key} {hist[key]}")
    if (mismatched or not unexpected or not missing
            or any(not k.startswith("pretrain_head.") for k in unexpected)
            or any(not k.startswith(f"{head}.") for k in missing)
            or trainer.pretrain_loaded != len(own) - len(missing)):
        raise AssertionError(f"{tag} checkpoint load: mismatched "
                             f"{mismatched}, missing {missing}, unexpected "
                             f"{unexpected}, loaded "
                             f"{trainer.pretrain_loaded} of {len(own)}")
    if (n_train < 2 or not all(math.isfinite(x) for x in losses)
            or len(set(losses)) < 2):
        raise AssertionError(f"{tag} losses not finite, too few or not "
                             f"moving: {losses}")
    want = {k: n * (n_train + n_eval) for k, n in FT_PER_FORWARD.items()}
    want.update({k: n * n_train for k, n in FT_PER_STEP.items()})
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want} "
                             f"({n_train} train steps, {n_eval} eval "
                             "batches)")
    need = {target} | ({"txt_acc"} if head == "ground_head" else set()) | (
        {f"type{t}_acc" for t in range(6)} if name == "sqa3d" else set())
    for key in ("val", "test"):
        if not hist[key]:
            if key == "test" or trainer.epochs_per_eval == 1:
                raise AssertionError(f"{tag} no {key} pass")
            continue  # sqa3d_finetune.yaml evaluates every 5 epochs
        res = hist[key][-1]
        bad = {k: v for k, v in res.items()
               if k != "best_result" and not 0.0 <= v <= 1.0}
        if bad or not need <= set(res):
            raise AssertionError(f"{tag} {key} metrics {res}, needs {need}")
    items = {s: sum(len(ld.dataset) for ld in eval_loaders(trainer, s))
             for s in ("train", "val", "test")}
    answers = getattr(trainer.data_loaders["train"].dataset.dataset,
                      "num_answers", None)
    log(f"{tag} items per split {items}" + (
        "" if answers is None else f", answer vocabulary {answers}"))
    if name in FT_ANSWERS and answers != FT_ANSWERS[name]:
        raise AssertionError(f"{tag} {answers} answers, expected "
                             f"{FT_ANSWERS[name]}")
    # the train loop's host clock per step, item building included: the
    # metrics log's train rows, one written at each step's fetch
    with open(os.path.join(trainer.cfg.exp_dir, "metrics.jsonl")) as f:
        ts = [r["_ts"] for r in map(json.loads, f) if "train/total_loss" in r]
    loop_step = (ts[-1] - ts[0]) / (len(ts) - 1)
    log(f"{tag} train loop {loop_step:.4f} s a step (host clock between the "
        f"steps' fetches, the batch's items built in this process)")
    pnet = trainer.model.point_encoder.point_feature_extractor
    info = {"config": config, "items": items, "answers": answers,
            "train_steps": n_train, "eval_batches": n_eval,
            "batch": batch, "losses": losses, "steady_step_s": steady,
            "loop_step_s": loop_step,
            "wall_s": wall, "peak_mem_gib": peak, "launches": launches,
            "loaded": trainer.pretrain_loaded, "missing": len(missing),
            "unexpected": len(unexpected),
            "val": hist["val"][-1] if hist["val"] else None,
            "test": hist["test"][-1]}
    info["eval_check"] = check_finetune_eval(tag, trainer, head)
    return info, trainer, pnet


def phase_finetune(table, pretrain_exp_dir):
    """The four ``configs/final/finetune`` configs (ScanRefer, ScanQA,
    Nr3D, SQA3D) through ``run_torch.main`` from the ``best.pth`` the data
    phase's all_pretrain run saved, on a tree of FT_TREE with its own QA
    files; on the ScanRefer run's first train batch (B = 256), ``fps`` and
    ``sa_group_mlp_pool`` at SA1 and SA2 and ``mha_*`` on one train step's
    operands against their twins; that step's device time and busy
    share."""
    import shutil

    import torch

    from sceneverse_tpu_torch.trainer.build import to_device

    t_phase = time.perf_counter()
    ckpt = os.path.join(pretrain_exp_dir, "ckpt", "best.pth")
    if not os.path.isfile(ckpt):
        raise AssertionError(f"[finetune] the all_pretrain run left no {ckpt}")
    state = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    ckpt_shapes = {k: tuple(v.shape) for k, v in state.items()}
    del state
    root = os.path.join(REPO, "build", "smoke_finetune")
    shutil.rmtree(root, ignore_errors=True)
    write_finetune_tree(root)
    log(f"[finetune] tree {FT_TREE} written (train scans "
        f"{FT_TRAIN_SCANS}, val / test 1, QA items {FT_QA_ITEMS}); "
        f"pretrain checkpoint {ckpt}")
    out = {"tree": FT_TREE, "qa_items": FT_QA_ITEMS, "reduced": FT_REDUCED,
           "ckpt": ckpt, "runs": {}}
    for name in FT_RUNS:
        info, trainer, pnet = _run_finetune(name, root, ckpt, ckpt_shapes)
        out["runs"][name] = info
        batch = None
        if name == "scanrefer":
            batch = next(iter(trainer.data_loaders["train"]))
            dev = to_device(batch, trainer.device)
            out["kernels"] = {"mha": mha_on_batch(table, trainer, dev,
                                                  "finetune")}
            step_ms, events = kernel_sum_ms(
                lambda: trainer.train_forward_backward(dev))
            out["device_step_ms"] = step_ms
            out["busy"] = {"step": step_ms / 1e3 / info["steady_step_s"],
                           "loop": step_ms / 1e3 / info["loop_step_s"]}
            log(f"[finetune scanrefer] one train step at batch "
                f"{info['batch']}: {step_ms:.2f} ms of device work "
                f"({events} events, torch.profiler); busy share of the "
                f"step (batch on the card to losses fetched) and of the "
                f"train loop: {out['busy']}")
            del dev
        del trainer
        _free()
        if batch is not None:  # the run's own batch through SA1 and SA2
            out["kernels"]["sa"] = sa_on_batch(
                table, torch.as_tensor(batch["obj_fts"]), pnet, "finetune")
        del pnet, batch
        _free()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[finetune] phase took {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------- objcls phase
# ObjCls, the object-encoder pretraining model, at full width: the config
# of tests/test_trainer_e2e.py with the GPS unfrozen slice's load, 32
# scenes x 80 objects x 1024 points a step (2560 objects), the PointNet++
# at clip width (SA3 to 512 channels), 607 classes and a 1024-wide head,
# AdamW under warmup_cosine, 2 epochs of 4 steps with val and test. The
# YAMLs are written under build/objcls/, not into configs/.
OBJCLS_DIR = os.path.join(REPO, "build", "objcls")
OBJCLS_CFG = {
    "name": "ObjClsSmoke", "rng_seed": 42, "num_gpu": 1, "mode": "train",
    "task": "ObjPretrain", "trainer": "ObjPretrainTrainer",
    "data": {"train": ["SyntheticObjDataset"], "val": ["SyntheticObjDataset"],
             "test": ["SyntheticObjDataset"], "synthetic_size": 128,
             "args": {"max_obj_len": 80, "num_points": 1024}},
    "dataloader": {"batchsize": 32, "num_workers": 0},
    "solver": {"gradient_accumulation_steps": 1, "epochs": 2,
               "epochs_per_eval": 1, "lr": 1e-3, "grad_norm": 5.0,
               "log_every": 1,
               "optim": {"name": "AdamW", "args": {"betas": [0.9, 0.98]}},
               "sched": {"name": "warmup_cosine",
                         "args": {"warmup_steps": 1}}},
    "eval": {"name": "PretrainObjEval", "save": False},
    "model": {"name": "ObjCls", "model_name": "pointnet++",
              "language_type": "clip", "open_vocab": False,
              "num_classes": 607, "cls_hidden": 1024,
              "loss_list": ["obj_cls_loss"],
              "vis_loss_list": ["obj_cls_loss"]},
}
# the SA level of ObjCls that no GPS path has: SA3 at clip width, 2560
# objects x 16 rows (the sa_train kernels' (label, m, ns, dims, dx)); its
# sa_pool_bwd grads are held to pool_bwd_grads_tol of its 2560 centers
OBJCLS_SA_TRAIN_LEVELS = [("ObjCls SA3", 1, 16, [259, 256, 512, 512], True)]
# literal route: SA1 samples and groups through fps + ball_group, SA2's FPS
# through fps; once per train step and per eval batch (eval runs the same
# route with BatchNorm on its running statistics)
OBJCLS_PER_FORWARD = {"ball_group": 1, "fps": 2}
# the on-disk family run: a fixture tree the size of a small ScanNet split
OBJCLS_TREE = {"n_scans": 32, "n_objects": 90, "pts_per_obj": 1200}
# OpenVocabPerScene: B scenes x L sentences, from SyntheticReferDataset items
PERSCENE = (8, 4)


def objcls_config(name):
    """The config dict of one ObjCls run: the full-width AdamW one
    (``objcls``), open vocabulary with Adam and warmup_exp, closed with SGD
    (momentum 0.9), or ScanNetPretrainObj from the fixture tree (batch 16,
    through ``MaskDatasetWrapper``, which pads the objects and adds their
    masks)."""
    import copy

    cfg = copy.deepcopy(OBJCLS_CFG)
    solver = cfg["solver"]
    if name == "objcls_adam_open":
        cfg["model"]["open_vocab"] = True
        solver["epochs"] = 1
        solver["optim"]["name"] = "Adam"
        solver["sched"]["name"] = "warmup_exp"
    elif name == "objcls_sgd":
        solver["epochs"] = 1
        solver["optim"] = {"name": "SGD", "args": {"momentum": 0.9}}
    elif name == "objcls_disk":
        solver["epochs"] = 1
        cfg["dataloader"]["batchsize"] = 16
        cfg["debug"] = {"flag": False, "debug_size": -1}
        cfg["data"] = {
            **{s: ["ScanNetPretrainObj"] for s in ("train", "val", "test")},
            "scan_family_base": os.path.join(OBJCLS_DIR, "tree"),
            "args": {"max_obj_len": 80, "num_points": 1024, "max_seq_len": 50,
                     "pc_type": "gt", "sem_type": "607",
                     "txt_mask_ratio": 0.15, "pc_mask_ratio": 0.1}}
        cfg["data_wrapper"] = {s: "MaskDatasetWrapper"
                               for s in ("train", "val", "test")}
    return cfg


def objcls_args(name, extra=(), write=True):
    """``run_torch`` arguments of an ObjCls run, its YAML written under
    build/objcls/ (unless ``write`` is False: a data-parallel rank reads
    the one its parent wrote)."""
    from sceneverse_tpu_torch.config import Config, save_config

    if write:
        os.makedirs(OBJCLS_DIR, exist_ok=True)
        save_config(Config(objcls_config(name)),
                    os.path.join(OBJCLS_DIR, f"{name}.yaml"))
    return ["--config-path", OBJCLS_DIR, "--config-name", name, *extra]


def _objcls_launches(tag, launches, n_train, n_eval, fused):
    """Exactly OBJCLS_PER_FORWARD a train step and an eval batch, the fused
    route's sa_* a train step, and no other kernel."""
    want = {k: n * (n_train + n_eval) for k, n in OBJCLS_PER_FORWARD.items()}
    if fused:
        want.update({k: n * n_train for k, n in SA_TRAIN_PER_STEP.items()})
    log(f"{tag} launches {launches} ({n_train} train steps, {n_eval} eval "
        "batches)")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")


def _run_objcls(name, env):
    """One ObjCls run through ``run_torch.main`` (``env`` set for it
    alone): every loss finite, the launches exact, every PointNet++ weight
    and BatchNorm statistic moved, val and test accuracy in [0, 1]; then
    one more train step on its first batch for the step's device time
    (torch.profiler, every device event summed) and peak memory."""
    import torch

    import run_torch
    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.trainer.build import to_device

    run = name + ("_fused" if env else "")
    tag = f"[objcls {run}]"
    args = objcls_args(name, [
        f"base_dir={os.path.join(REPO, 'build', 'smoke_runs', run)}"])
    with gates(env):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        result = run_torch.main(args)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        run_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        trainer = result["trainer"]
        hist = trainer.history
        cfg = trainer.cfg
        n_train = len(hist["train"])
        n_eval = sum(len(hist[s]) * sum(len(ld) for ld in
                                        eval_loaders(trainer, s))
                     for s in ("val", "test"))
        losses = [r["total_loss"] for r in hist["train"]]
        steps = int(cfg.solver.epochs) * len(trainer.data_loaders["train"])
        log(f"{tag} {n_train} train steps at batch "
            f"{cfg.dataloader.batchsize} x {cfg.data.args.max_obj_len} "
            f"objects x {cfg.data.args.num_points} points and {n_eval} eval "
            f"batches in {wall:.1f} s (host clock, data, build and saves "
            f"included); losses {[round(x, 4) for x in losses]}; val "
            f"{hist['val']}; test {hist['test']}; run peak {run_peak:.2f} GiB")
        if n_train != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{tag} losses {losses}, {steps} steps due")
        _objcls_launches(tag, launches, n_train, n_eval, bool(env))
        for key in ("val", "test"):
            acc = [r["accuracy"] for r in hist[key]]
            if not acc or not all(0.0 <= a <= 1.0 for a in acc):
                raise AssertionError(f"{tag} {key} accuracy {acc}")
        built = build_model(cfg, generator=torch.Generator().manual_seed(
            int(cfg.get("rng_seed", 42)))).state_dict()
        trained = trainer.model.state_dict()
        pnet = [k for k in built if k.startswith("point_feature_extractor.")
                and not k.endswith("num_batches_tracked")]
        same = [k for k in pnet
                if torch.equal(built[k], trained[k].detach().cpu())]
        moved = [k for k in built if not k.endswith("num_batches_tracked")
                 and not torch.equal(built[k], trained[k].detach().cpu())]
        log(f"{tag} tensors changed by training: {len(moved)} of "
            f"{len(built)}, PointNet++ {len(pnet) - len(same)} of "
            f"{len(pnet)}")
        if same or len(pnet) != 3 * 3 * 5 + 2:
            raise AssertionError(f"{tag} PointNet++ tensors unchanged: {same}")
        batch = to_device(next(iter(trainer.data_loaders["train"])),
                          trainer.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, events = kernel_sum_ms(
            lambda: trainer.train_forward_backward(batch))
        step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} one train step: {step_ms:.3f} ms of device work "
        f"({events} device events, torch.profiler), peak memory "
        f"{step_peak:.2f} GiB")
    info = {"wall_s": wall, "train_steps": n_train, "eval_batches": n_eval,
            "losses": losses, "val": list(hist["val"]),
            "test": list(hist["test"]),
            "launches": launches, "run_peak_mem_gib": run_peak,
            "step_device_ms": step_ms, "step_device_events": events,
            "step_peak_mem_gib": step_peak, "moved": len(moved),
            "tensors": len(built)}
    del batch, built, trained
    return info, trainer


def objcls_oracle(trainer):
    """The val pass through ``PretrainObjEval`` with the model's logits
    replaced by one-hot logits at each object's label: accuracy 1."""
    import torch

    n_cls = int(trainer.cfg.model.num_classes)

    def oracle(batch):
        labels = batch["obj_labels"].long().clamp_min(0)
        return {"obj_logits": torch.nn.functional.one_hot(labels,
                                                          n_cls).float()}

    trainer.forward, trainer.log = oracle, lambda *a, **k: None
    try:
        with eager_eval(trainer):
            res = trainer._eval_loop("val", "val")[1]
    finally:
        del trainer.forward, trainer.log
    log(f"[objcls] val on oracle logits: {res}")
    if res["accuracy"] != 1.0:
        raise AssertionError(f"[objcls] oracle accuracy {res['accuracy']}")
    return res["accuracy"]


def objcls_reload(trainer, run):
    """``run_torch.main`` with ``mode=test pretrain_ckpt_path=`` the run's
    ``best.pth``: it loads every tensor of the state dict, launches the
    literal route once a test batch and gives the test accuracy that the
    trained trainer's own test pass gives from that state (and, when the
    last epoch was the best, the run's test accuracy)."""
    import torch

    import run_torch
    from sceneverse_tpu_torch.ops import _build

    tag = "[objcls mode=test]"
    best = trainer.ckpt_path / "best.pth"
    val = [r["accuracy"] for r in run["val"]]
    best_epoch = val.index(max(val)) + 1
    state = torch.load(best, map_location=trainer.device,
                       weights_only=True)["model"]
    trainer.model.load_state_dict(state)
    trainer.log = lambda *a, **k: None
    want = trainer.test_step()["accuracy"]
    if best_epoch == len(val) and want != run["test"][-1]["accuracy"]:
        raise AssertionError(f"{tag} best.pth is the final state, yet its "
                             f"test accuracy {want} is not the run's "
                             f"{run['test'][-1]['accuracy']}")
    _build.reset_launches()
    result = run_torch.main(objcls_args("objcls", [
        "mode=test", f"pretrain_ckpt_path={best}",
        f"base_dir={os.path.join(REPO, 'build', 'smoke_runs', 'objcls_test')}"
    ]))
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    test = result["trainer"]
    n_state = len(test.model.state_dict())
    got = result["results"]["accuracy"]
    log(f"{tag} loaded {test.pretrain_loaded} of {n_state} tensors from "
        f"best.pth (epoch {best_epoch} of {len(val)}); test accuracy {got}, "
        f"the trainer's own pass from that state {want}")
    if test.pretrain_loaded != n_state or test.history["train"]:
        raise AssertionError(f"{tag} loaded {test.pretrain_loaded} of "
                             f"{n_state} tensors or trained")
    _objcls_launches(tag, launches, 0,
                     sum(len(ld) for ld in eval_loaders(test, "test")), False)
    if got != want:
        raise AssertionError(f"{tag} test accuracy {got}, expected {want}")
    return {"best_epoch": best_epoch, "loaded": test.pretrain_loaded,
            "state_tensors": n_state, "test_accuracy": got,
            "launches": launches}


def _perscene_batch(cfg, device):
    """B scenes' objects from the first B SyntheticReferDataset val items
    and each scene's L sentences from items b * L + l: txt_ids,
    txt_masks and masked_lm_labels (B, L, T)."""
    import torch

    from sceneverse_tpu_torch.data.build import DATASET_REGISTRY, numpy_collate

    B, L = PERSCENE
    ds = DATASET_REGISTRY.get("SyntheticReferDataset")(cfg, "val")
    items = numpy_collate([ds[i] for i in range(B * L)])
    batch = {k: v[:B] for k, v in items.items() if k.startswith("obj_")}
    for k in ("txt_ids", "txt_masks", "masked_lm_labels"):
        batch[k] = items[k].reshape(B, L, -1)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_perscene():
    """``OpenVocabPerScene`` at the SLICE_ARGS width on a B x L per-scene
    batch: the eval forward's og3d logits (B, L, 80), its ``mha_fwd``
    launches one per attention layer (the spatial encoder at B, the
    utterance tower and the unified encoder at B * L); the outputs both
    variants make against ``OpenVocab`` with the same weights on the B * L
    rows with each scene's objects repeated (TOL["f32"]); one train-mode
    backward of ``lm_cls_loss``, which launches ``mha_bwd``."""
    import torch

    import run_torch
    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.modules.utils import set_generators
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.optim.loss.loss import lm_cls_loss

    B, L = PERSCENE
    tag = "[perscene]"
    cfg = run_torch.load_cfg(SLICE_ARGS + [
        "model.name=OpenVocabPerScene",
        f"exp_dir={os.path.join(REPO, 'build', 'smoke_runs', 'perscene')}"])
    dev = torch.device("cuda")
    seed = int(cfg.get("rng_seed", 42))
    model = build_model(cfg, generator=torch.Generator().manual_seed(
        seed)).to(dev)
    set_generators(model, seed, dev)
    batch = _perscene_batch(cfg, dev)
    m = cfg.model
    layers = (int(m.vision.args.num_layers)
              + int(m.language.args.num_hidden_layers)
              + int(m.grounding.args.num_layers))
    model.eval()
    with torch.no_grad():
        _build.reset_launches()
        out = model(batch)
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    log(f"{tag} eval forward at B={B} scenes x L={L} sentences: og3d "
        f"{tuple(out['og3d_logits'].shape)}, launches {launches}")
    if tuple(out["og3d_logits"].shape) != (B, L, cfg.data.args.max_obj_len):
        raise AssertionError(f"{tag} og3d {tuple(out['og3d_logits'].shape)}")
    want = {"fps": 2, "sa_group_mlp_pool": 2, "mha_fwd": layers}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    ov_cfg = run_torch.load_cfg(SLICE_ARGS + ["model.name=OpenVocab"])
    ov = build_model(ov_cfg).to(dev)
    ov.load_state_dict(model.state_dict())
    ov.eval()
    flat = {k: v.repeat_interleave(L, 0) for k, v in batch.items()
            if k.startswith("obj_")}
    for k in ("txt_ids", "txt_masks", "masked_lm_labels"):
        flat[k] = batch[k].reshape(B * L, -1)
    with torch.no_grad():
        ref = ov(flat)
    errs = {}
    for k in ("og3d_logits", "txt_lm_cls_logits", "obj_cls_post_logits",
              "intra_text_embed", "intra_obj_embeds", "inter_text_embed",
              "inter_obj_embeds"):
        got = out[k].reshape(ref[k].shape)
        err, scale = _err(got, ref[k])
        errs[k] = err / max(scale, 1e-30)
    labels_equal = torch.equal(out["masked_lm_labels"].reshape(B * L, -1),
                               ref["masked_lm_labels"])
    log(f"{tag} against OpenVocab on {B * L} rows, objects repeated: "
        f"max_rel_err {errs}, gathered labels equal {labels_equal}")
    if not (labels_equal and max(errs.values()) <= TOL["f32"]):
        raise AssertionError(f"{tag} differs from OpenVocab: {errs}")
    model.train()
    _build.reset_launches()
    out = model(batch)
    loss = lm_cls_loss(out)
    loss.backward()
    train = {k: v for k, v in _build.LAUNCHES.items() if v}
    loss = float(loss.detach())
    log(f"{tag} train forward + lm_cls_loss backward (loss {loss:.4f}): "
        f"launches {train}")
    if not math.isfinite(loss) or train.get("mha_bwd", 0) <= 0 \
            or train.get("mha_fwd") != layers:
        raise AssertionError(f"{tag} train launches {train}")
    del model, ov, out, ref, batch, flat
    _free()
    return {"eval_launches": launches, "train_launches": train,
            "max_rel_err": errs, "lm_cls_loss": loss}


def phase_objcls(table):
    """ObjCls and OpenVocabPerScene on the card: the four ``sa_train``
    kernels at ObjCls's SA3 (256, 512, 512; no GPS path has that width);
    the full-width run on the literal route and on the fused route (the
    two gates set for that run only); the val pass on oracle logits; the
    ``mode=test`` reload of ``best.pth``; Adam with warmup_exp on the open
    vocabulary and SGD on the closed one, an epoch each; ScanNetPretrainObj
    from a fixture tree at batch 16; ``phase_perscene``."""
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree

    t_phase = time.perf_counter()
    phase_sa_train(table, OBJCLS_SA_TRAIN_LEVELS, per_level_tol=True)
    out = {"runs": {}}
    out["runs"]["objcls"], trainer = _run_objcls("objcls", {})
    out["oracle_accuracy"] = objcls_oracle(trainer)
    out["entry"] = objcls_reload(trainer, out["runs"]["objcls"])
    del trainer
    _free()
    out["runs"]["objcls_fused"], trainer = _run_objcls("objcls", FUSED_ENV)
    del trainer
    _free()
    t0 = time.perf_counter()
    write_synthetic_tree(os.path.join(OBJCLS_DIR, "tree"), **OBJCLS_TREE)
    log(f"[objcls] tree {OBJCLS_TREE} written in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("objcls_adam_open", "objcls_sgd", "objcls_disk"):
        out["runs"][name], trainer = _run_objcls(name, {})
        del trainer
        _free()
    out["perscene"] = phase_perscene()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[objcls] phase took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- data parallel
# The card is one device and NCCL refuses two ranks on one device, so the
# phase runs two worlds through run_torch.main in child processes: the
# reference, a world of 1 over NCCL at the global batch, then a world of 2
# over gloo on cuda:0 at half the batch a rank. Each child joins its world
# by mesh.init_from_env from torchrun's variables and drives every run.
# frozen: 3 steps (97 items at 32: the drop-last loader), then val and test
# over 97 items (odd: shards of 49 and 48); unfrozen_fused: 2 steps (65);
# objcls: the ObjCls run (OBJCLS_CFG, literal route) for 2 steps (65
# items), the model of the reference's SyncBatchNorm; these three at one
# step a dispatch, the trainer's default. frozen_k2: the frozen run at
# DDP_K steps a dispatch over 7 steps (225 items): three chunks through
# train_forward_backward_k and a tail step; the world of 1 runs the first
# chunk eagerly, captures the second and replays it, replays it again for
# the third, and its eval runs through eval_fused's graphs; the gloo ranks
# run each chunk's steps in a row without a graph. Each run: (its ObjCls
# config name, or None for SLICE_ARGS; overrides; environment; the kernels
# its path must launch).
DDP_K = 2
DDP_RUNS = {
    "frozen": (None, ["data.synthetic_size=97"], {}, PATHS["frozen"][1]),
    "unfrozen_fused": (None, ["model.vision.args.freeze=False",
                              "data.synthetic_size=65"], FUSED_ENV,
                       PATHS["unfrozen_fused"][1]),
    "objcls": ("objcls", ["data.synthetic_size=65", "solver.epochs=1",
                          "solver.optim.args.eps=1e-6"], {},
               tuple(OBJCLS_PER_FORWARD)),
    "frozen_k2": (None, ["data.synthetic_size=225",
                         f"solver.steps_per_dispatch={DDP_K}"], {},
                  PATHS["frozen"][1]),
}
DDP_WORLDS = ((1, "nccl"), (2, "gloo"))
# 2 ranks against 1, dropout off. frozen: f32 summed in another order
# (the CPU test measured 2.6e-7 relative L2 on the gradients). Parameters,
# in units of lr x steps beyond 1e-5 max|p|: Adam normalises an element
# whose gradient sits near its eps (1e-8 here) from a noisy value, so a
# few elements take a visibly different fraction of their step; as
# test_torch_slice.py holds them: none beyond 0.25 ("param_lr"), at most
# 0.1% of a tensor's elements beyond 0.01 ("param_share"). Eval metrics
# within one item of the split (an argmax may land the other way on a near
# tie). unfrozen_fused: its bf16 rounding with (a, b) folded from the
# moments flips roundings and pool argmaxes when the moments' summation
# order changes (on the CPU a permutation of the rows alone moved its
# losses by up to 3.6e-4, its gradients by 4.8% relative L2, deeper
# statistics by 3.9e-4); SA1's three layers and SA2's first see no bf16
# rounding before their moments and hold 1e-5 at step 1; after step 1 the
# weights differ by up to 2 lr an element, so later steps are held to the
# route's own bounds. Eval metrics: absolute, about one item of the smallest
# subset (ScanRefer's unique / multiple items) for frozen, a few for fused.
# objcls: f32 with the moments summed in another order, as frozen, but its
# PointNet++ trains: a ReLU whose input lies within rounding of its
# channel's batch mean lands the other way in one world (a 32-fold copied
# SA2 row did on the CPU, tests/test_torch_ddp.py: 1.3e-3 relative L2 over
# the gradients), so the step-1 gradients are held to 1e-2 relative L2.
# The schedule's warmup makes step 1's LR 0, so step 2 runs at the same
# weights: its loss and both steps' statistics are forward quantities
# (1e-5). Step 2's gradient may carry such a flip too, and Adam turns a 1%
# gradient difference into 1% of lr on every element, so the parameters are
# held to Adam's bound of 2 lr alone, as the fused route's; accuracy within
# 0.01 (one object is 2e-4 of the split's valid objects)
DDP_TOL = {
    "frozen": {"loss": 1e-5, "later_loss": 1e-5, "grad_l2": 1e-5,
               "param_lr": 0.25, "param_share": 1e-3, "stat1": 0.0,
               "stat1_exact": 0.0, "stat": 0.0, "eval_abs": 0.03},
    "unfrozen_fused": {"loss": 2e-3, "later_loss": 1e-2, "grad_l2": 0.25,
                       "param_lr": 2.0, "param_share": 1.0, "stat1": 2e-3,
                       "stat1_exact": 1e-5, "stat": 1e-2, "eval_abs": 0.1},
    "objcls": {"loss": 1e-5, "later_loss": 1e-5, "grad_l2": 1e-2,
               "param_lr": 2.0, "param_share": 1.0, "stat1": 1e-5,
               "stat1_exact": 0.0, "stat": 1e-5, "eval_abs": 0.01},
}
# frozen_k2: frozen's bounds, but over 7 updates its parameters spread
# apart even between two runs of one world (on the H100: a world of 1
# against a world of 1, 0.40 lr x steps and 9.8e-4 of a tensor beyond
# 0.01; a world of 2 against a world of 2, 0.32 and 2.4e-5; CUDA backwards
# round about 1e-7 apart across processes and Adam normalises the noisy
# small gradients of the 1e-5-lr word embeddings into steps of about lr):
# held to Adam's bound of 2 lr an update, as unfrozen_fused and objcls,
# and at most 1% of a tensor's elements beyond 0.01; its losses, step-1
# gradient, statistics and eval metrics stay at frozen's bounds
DDP_TOL["frozen_k2"] = dict(DDP_TOL["frozen"], param_lr=2.0, param_share=1e-2)
DDP_EXACT_STATS = ("point_encoder.point_feature_extractor.encoder.0.",
                   "point_encoder.point_feature_extractor.encoder.1.mlps.0."
                   "layer0.")
DDP_TIMEOUT_S = 400


def ddp_child(spec):
    """One rank: joins the world that torchrun's variables describe, then
    drives each run through ``run_torch.main`` with every dropout at 0 (a
    rank's dropout streams differ from one process's by design); keeps the
    step-1 summed gradient (before the clip) and BatchNorm statistics, the
    final state, and rank 0's state against every rank's."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    import run_torch
    from sceneverse_tpu_torch.modules import utils as mutils
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.parallel import mesh
    from sceneverse_tpu_torch.trainer import build as tbuild

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init = mutils.Dropout.__init__
    mutils.Dropout.__init__ = lambda self, p: init(self, 0.0)
    held = {}
    build_trainer = tbuild.build_trainer

    def build(cfg, device=None):
        t = held["trainer"] = build_trainer(cfg, device=device)
        real = t.train_forward_backward_k
        held["chunks"] = []
        t.train_forward_backward_k = lambda d, f: held["chunks"].append(
            len(d)) or real(d, f)
        return t

    tbuild.build_trainer = build
    replay, capture = tbuild._Graph.replay, tbuild.BaseTrainer._capture

    def counted_replay(self, trainer):
        replays = held.setdefault("replays", {})
        replays[self.kind] = replays.get(self.kind, 0) + 1
        return replay(self, trainer)

    def named_capture(self, fn, key):  # key[0]: "train" or "eval"
        held.setdefault("graphs", []).append(key[0])
        g = capture(self, fn, key)
        g.kind = key[0]
        return g

    tbuild._Graph.replay = counted_replay
    tbuild.BaseTrainer._capture = named_capture
    reduce = mesh.all_reduce_flat

    def reduce_and_keep(tensors):
        reduce(tensors)
        if len(tensors) > 1 and "grad" not in held:  # the optimizer's, step 1
            held["grad"] = torch.cat([t.reshape(-1) for t in tensors]).cpu()
            held["stats1"] = {
                n: b.detach().cpu().clone() for n, b in
                held["trainer"].model.named_buffers() if "running" in n}

    mesh.all_reduce_flat = reduce_and_keep
    common = ["solver.log_every=1", f"dist_backend={spec['backend']}"]
    args = SLICE_ARGS + common
    made = mesh.init_from_env(run_torch.dist_backend(
        run_torch.load_cfg(args)))
    if not made or mesh.world() != spec["world"]:
        raise AssertionError(f"[ddp] rank did not join a world of "
                             f"{spec['world']}")
    r = mesh.rank()
    for name in spec["runs"]:
        base, extra, env, _ = DDP_RUNS[name]
        held.clear()
        torch.cuda.reset_peak_memory_stats()
        with gates(env):
            _build.reset_launches()
            t0 = time.perf_counter()
            out = run_torch.main(
                (args if base is None else
                 objcls_args(base, common, write=False)) + extra
                + [f"base_dir={os.path.join(spec['out'], name)}"])
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        trainer = out["trainer"]
        state = {k: v.detach() for k, v in trainer.model.state_dict().items()}
        flat = torch.cat([v.float().reshape(-1) for v in state.values()])
        ref = flat.clone()
        if mesh.world() > 1:
            dist.broadcast(ref, 0)
        rank_diff = (flat - ref).abs().max()
        if mesh.world() > 1:
            dist.all_reduce(rank_diff, op=dist.ReduceOp.MAX)
        hist = trainer.history
        info = {"rank": r, "world": mesh.world(), "backend": spec["backend"],
                "device": str(trainer.device), "launches": launches,
                "rows": hist["train"], "val": hist["val"][-1],
                "test": hist["test"][-1], "wall_s": wall,
                "eval_batches": sum(len(ld) for s in ("val", "test")
                                    for ld in eval_loaders(trainer, s)),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "rank_max_diff": float(rank_diff),
                "chunks": held["chunks"], "replays": held.get("replays", {}),
                "graphs": held.get("graphs", [])}
        lrs = {id(p): g["base_lr"] for g in trainer.optimizer.opt.param_groups
               for p in g["params"]}
        if r == 0:
            torch.save({"grad": held["grad"], "stats1": held["stats1"],
                        "state": {k: v.cpu() for k, v in state.items()},
                        "lr": {n: lrs.get(id(p)) for n, p in
                               trainer.model.named_parameters()}},
                       os.path.join(spec["out"], f"{name}.pt"))
        with open(os.path.join(spec["out"], f"{name}_r{r}.json"), "w") as f:
            json.dump(info, f)
        del out, trainer, state, flat, ref
        held.clear()
        _free()
    mesh.shutdown()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ddp_world(world, backend):
    """The world's ranks as child processes of this script, all on cuda:0;
    a child that exits non-zero (or outlives DDP_TIMEOUT_S) fails the
    phase."""
    import shutil

    out = os.path.join(REPO, "build", "smoke_ddp", f"w{world}_{backend}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    spec = {"world": world, "backend": backend, "out": out,
            "runs": list(DDP_RUNS)}
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        logs.append(open(os.path.join(out, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ddp-child",
             json.dumps(spec)], env=env, cwd=REPO, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, DDP_TIMEOUT_S - (time.perf_counter()
                                                     - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.log")) as f:
                log(f"[ddp] world {world} rank {r} log tail:\n"
                    + "".join(f.readlines()[-40:]))
        raise AssertionError(f"[ddp] world {world} over {backend}: exit "
                             f"codes {codes}")
    info = {}
    for name in DDP_RUNS:
        info[name] = []
        for r in range(world):
            with open(os.path.join(out, f"{name}_r{r}.json")) as f:
                info[name].append(json.load(f))
    return out, info, time.perf_counter() - t0


def _ddp_compare(name, ref_dir, dist_dir, ref, ranks):
    """Errors of the 2-rank run against the 1-rank run (DDP_TOL)."""
    import torch

    tol = DDP_TOL[name]
    a = torch.load(os.path.join(ref_dir, f"{name}.pt"), weights_only=True)
    b = torch.load(os.path.join(dist_dir, f"{name}.pt"), weights_only=True)
    err = {}
    # per-step logged losses (global), relative to max(1, |ref|)
    keys = [k for k in ref[0]["rows"][0] if k.endswith("loss")
            or k in ("TextObjWithinBatch", "TextSceneBetweenBatch")]
    n_steps = len(ref[0]["rows"])
    for step in range(n_steps):
        want = ref[0]["rows"][step]
        for r in ranks:
            got = r["rows"][step]
            e = max(abs(got[k] - want[k]) / max(1.0, abs(want[k]))
                    for k in keys)
            key = "loss" if step == 0 else "later_loss"
            err[key] = max(err.get(key, 0.0), e)
    err["grad_l2"] = float((b["grad"] - a["grad"]).norm()
                           / a["grad"].norm())
    e1 = e1x = 0.0
    for n, v in a["stats1"].items():
        rel = float((b["stats1"][n] - v).abs().max()
                    / v.abs().max().clamp_min(1e-30))
        if n.startswith(DDP_EXACT_STATS):
            e1x = max(e1x, rel)
        else:
            e1 = max(e1, rel)
    err["stat1"], err["stat1_exact"] = e1, e1x
    ep = eshare = es = 0.0
    worst = None
    for n, v in a["state"].items():
        w = b["state"][n]
        if not v.is_floating_point():
            if not torch.equal(v, w):
                raise AssertionError(f"[ddp {name}] {n}: {v} vs {w}")
            continue
        d = (w - v).abs()
        lr = a["lr"].get(n)
        if lr is not None:
            units = (d - 1e-5 * v.abs().max()) / (lr * n_steps)
            if units.max().item() > ep:
                ep, worst = units.max().item(), n
            eshare = max(eshare, (units > 0.01).float().mean().item())
        elif "running" in n:
            es = max(es, d.max().item() / max(v.abs().max().item(), 1e-30))
        elif d.max().item():
            raise AssertionError(f"[ddp {name}] {n}: not optimised, yet "
                                 f"{d.max().item()} apart")
    err["param_lr"], err["param_share"], err["stat"] = ep, eshare, es
    err["eval_abs"] = max(abs(r[split][k] - v) for split in ("val", "test")
                          for k, v in ref[0][split].items() for r in ranks
                          if r[split])  # a run may skip val
    bad = {k: (v, tol[k]) for k, v in err.items() if not v <= tol[k]}
    return err, bad, worst


def phase_ddp():
    """Data parallelism on the one card: the frozen, the unfrozen_fused
    (SLICE_ARGS widths) and the ObjCls run at one step a dispatch and the
    frozen run at DDP_K (DDP_RUNS, f32, dropout off) in a world of 1 over
    NCCL at batch 32, then in a world of 2 over gloo on cuda:0 at 16 a
    rank; the 2-rank world against the 1-rank one (DDP_TOL), every rank
    bit-equal to rank 0, every kernel of each path launched on each rank
    (the fused ``sa_*`` kernels exactly as often per step as three fused
    levels need, ObjCls's exactly as often per step and eval batch as its
    literal route needs), the K-step chunks of each rank and the graphs
    only the world of 1 captures and replays, launch counts and host-clock
    step times per rank."""
    t_phase = time.perf_counter()
    for base, *_ in DDP_RUNS.values():  # the children read these
        if base is not None:
            objcls_args(base)
    worlds = {}
    for world, backend in DDP_WORLDS:
        worlds[world] = _ddp_world(world, backend)
        log(f"[ddp] world {world} over {backend}: every run in "
            f"{worlds[world][2]:.1f} s (host clock, process starts "
            "included)")
    (ref_dir, ref_info, _), (dist_dir, dist_info, _) = worlds[1], worlds[2]
    out, failed = {"runs": {}}, {}
    for name in DDP_RUNS:
        ref, ranks = ref_info[name], dist_info[name]
        tag = f"[ddp {name}]"
        err, bad, worst = _ddp_compare(name, ref_dir, dist_dir, ref, ranks)
        steps = [[row["step_s"] for row in r["rows"]] for r in ref + ranks]
        for world, rs in ((1, ref), (2, ranks)):
            for r in rs:
                st = [row["step_s"] for row in r["rows"]]
                log(f"{tag} world {world} over {r['backend']} rank "
                    f"{r['rank']} on {r['device']}: losses "
                    f"{[round(row['total_loss'], 6) for row in r['rows']]}, "
                    f"step_s {[round(s, 4) for s in st]} (host clock), "
                    f"steady {statistics.mean(st[1:]):.4f} s, eval "
                    f"batches {r['eval_batches']}, peak "
                    f"{r['peak_mem_gib']:.2f} GiB, launches {r['launches']}, "
                    f"K-step chunks {r['chunks']}, graphs {r['graphs']}, "
                    f"replays {r['replays']}")
        for r in ref + ranks:
            where = f"world {r['world']} rank {r['rank']}"
            missing = [k for k in DDP_RUNS[name][3]
                       if r["launches"].get(k, 0) <= 0]
            if missing:
                bad[f"{where} never launched"] = missing
            if name == "objcls":
                n = len(r["rows"]) + r["eval_batches"]
                want = {k: per * n for k, per in OBJCLS_PER_FORWARD.items()}
                if r["launches"] != want:
                    bad[f"{where} launches"] = (r["launches"], want)
            if name == "unfrozen_fused":
                n = len(r["rows"])
                for k, per in SA_TRAIN_PER_STEP.items():
                    if r["launches"].get(k, 0) != per * n:
                        bad[f"{where} {k} launches"] = (
                            r["launches"].get(k, 0), per * n)
            if r["rank_max_diff"] != 0.0:
                bad[f"{where} state against rank 0"] = r["rank_max_diff"]
            k = DDP_K if name == "frozen_k2" else 1
            n_rows = len(r["rows"])
            if r["chunks"] != ([k] * (n_rows // k) if k > 1 else []):
                bad[f"{where} K-step chunks"] = (r["chunks"], n_rows)
            # at K = 2 the world of 1 replays the train chunk's graph for
            # chunks 2 and 3 (its eval splits replay graphs at every K); no
            # rank of the world of 2 captures
            graphed = (r["world"] == 1 and k > 1)
            if (("train" in r["graphs"]) != graphed
                    or (r["replays"].get("train", 0) >= 2) != graphed
                    or (r["world"] > 1 and (r["graphs"] or r["replays"]))):
                bad[f"{where} graphs"] = (r["graphs"], r["replays"])
            if len(r["rows"]) != len(ref[0]["rows"]):
                bad[f"{where} steps"] = len(r["rows"])
        log(f"{tag} world 2 (gloo) against world 1 (nccl): " + ", ".join(
            f"{k} {v:.3g} (tol {DDP_TOL[name][k]})" for k, v in err.items())
            + f"; the largest parameter difference in {worst}")
        if bad:
            failed[name] = bad
        out["runs"][name] = {
            "errors": err, "tol": DDP_TOL[name], "worst_param": worst,
            "launches": {f"w{r['world']}_r{r['rank']}": r["launches"]
                         for r in ref + ranks},
            "step_s": {f"w{r['world']}_r{r['rank']}": s
                       for r, s in zip(ref + ranks, steps)},
            "peak_mem_gib": {f"w{r['world']}_r{r['rank']}": r["peak_mem_gib"]
                             for r in ref + ranks},
            "val": [r["val"] for r in ref + ranks],
            "test": [r["test"] for r in ref + ranks]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[ddp] phase took {out['seconds']:.1f} s")
    if failed:
        raise AssertionError(f"[ddp] beyond tolerance: {failed}")
    return out


# ------------------------------------------------- the dp x mp process grid
# The LM head split over the vocabulary (parallel.mp = 2: the 30522-way text
# head, 15261 rows a rank; the 607-way object head whole), in worlds
# started through launch_torch.py's spmd mode as a user starts them: (a)
# dp 1 x mp 2 and (b) dp 2 x mp 2, every rank a process that
# torch.distributed.run starts, all on cuda:0 over gloo (NCCL refuses two
# ranks on one card). The settings are phase_ddp's frozen run (SLICE_ARGS
# widths, f32 with TF32 off, batch 32, 97 items: 3 train steps, val and
# test over 97 items, every dropout at 0), so phase_ddp's world of 1 is
# the reference; (a) skips val (it writes no checkpoint). After (b)'s run
# its processes take one more train step with dropout on. Each process
# runs ``mp_child`` (installed by the ``sitecustomize`` that ``_mp_world``
# puts on the children's path), which times the collectives with CUDA
# events and writes what the parent compares. Tolerances: DDP_TOL["frozen"]
# (the grid sums the same f32 rows in another order, as phase_ddp's world
# of 2 does); the mp peers' summed replicated gradients before the
# replicas' broadcast within MP_PEER_TOL (relative L2: a CUDA backward with
# atomics may round them apart by about 1e-7; masks drawn apart would move
# them by O(1)).
MP_WORLDS = {"w2_mp2": (2, 2, ["solver.epochs_per_eval=0"]),
             "w4_mp2": (4, 2, [])}  # (processes, mp, overrides)
MP_PEER_TOL = 1e-5
MP_TIMEOUT_S = 300
MP_HEAD = ("pretrain_head.lm_pred_head.bias",
           "pretrain_head.lm_pred_head.decoder.weight")
MP_HOOK = """import json, os, sys
spec = os.environ.get("SCENEVERSE_MP_CHILD")
if spec and "RANK" in os.environ:  # a rank, not torch.distributed.run
    spec = json.loads(spec)
    sys.path.insert(0, spec["repo"])
    import chip_smoke
    chip_smoke.mp_child(spec)
"""


def mp_child(spec):
    """Instruments one rank of a phase_mp world before ``run_torch`` runs
    in it (imported by the children's ``sitecustomize``): TF32 off, dropout
    at 0, CUDA events around the head's all-gather and its input's
    gradient sum, the clip's all-reduce, the replicas' broadcast and the dp
    gradient sum; the step-1 gradients before the clip (summed, broadcast,
    the head gathered), after it, and the summed replicated gradients the
    broadcast is handed; host-clock stamps of the process's stages. After
    the run: ``mp_dump``, then, for ``spec["dropout_step"]``, one train
    step with every dropout at its configured rate and ``mp_dump`` again."""
    stamps = {"hook": time.time()}
    import torch

    from sceneverse_tpu_torch.modules import utils as mutils
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.optim import build as obuild
    from sceneverse_tpu_torch.parallel import mesh, vocab
    from sceneverse_tpu_torch.trainer import build as tbuild
    from sceneverse_tpu_torch.trainer.build import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init = mutils.Dropout.__init__

    def no_dropout(self, p):
        init(self, 0.0)
        self.configured_p = p

    mutils.Dropout.__init__ = no_dropout
    held = {"events": collections.defaultdict(list), "stamps": stamps}

    def timed(name, fn, when=lambda *a: True):
        def run(*a):
            if not when(*a):
                return fn(*a)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a)
            end.record()
            held["events"][name].append((start, end))
            return out
        return run

    vocab._GatherLogits.forward = staticmethod(timed(
        "head_gather", vocab._GatherLogits.forward))
    head_backward = vocab._HeadInput.backward

    def timed_head_backward(ctx, g):
        return timed("head_input_grad_sum",
                     lambda g: head_backward(ctx, g))(g)

    vocab._HeadInput.backward = staticmethod(timed_head_backward)
    mesh.all_reduce_sum = timed("clip_all_reduce", mesh.all_reduce_sum,
                                lambda x, axis="dp": axis == "mp")
    mesh.all_reduce_flat = timed("dp_grad_sum", mesh.all_reduce_flat,
                                 lambda ts, axis="dp": len(ts) > 1)
    broadcast = mesh.broadcast_flat_mp

    def keep_and_broadcast(tensors):
        if "handed" not in held:
            held["handed"] = torch.cat([t.reshape(-1) for t in tensors])
        broadcast(tensors)

    mesh.broadcast_flat_mp = timed("replica_broadcast", keep_and_broadcast)

    def flat_whole(grads, split):
        return torch.cat([(vocab.full_tensor(g) if s else g).reshape(-1)
                          for g, s in zip(grads, split)]).cpu()

    split_norm = obuild.GPSOptimizer._split_norm

    def keep_and_norm(grads, split):
        if "grad" not in held:
            held["grad"] = flat_whole(grads, split)
            held["stats1"] = {
                n: b.detach().cpu().clone() for n, b in
                held["trainer"].model.named_buffers() if "running" in n}
        return split_norm(grads, split)

    obuild.GPSOptimizer._split_norm = staticmethod(keep_and_norm)
    step = obuild.GPSOptimizer.step

    def step_and_keep(self):
        moved = step(self)
        if "clipped" not in held:
            held["clipped"] = flat_whole([p.grad for p in self.params],
                                         [vocab.is_split(p)
                                          for p in self.params])
        return moved

    obuild.GPSOptimizer.step = step_and_keep
    build_trainer = tbuild.build_trainer

    def build(cfg, device=None):
        stamps["build"] = time.time()
        t = held["trainer"] = build_trainer(cfg, device=device)
        stamps["built"] = time.time()
        run = t.run

        def run_and_dump():
            results = run()
            stamps["ran"] = time.time()
            mp_dump(spec, t, held, "frozen")
            if spec["dropout_step"]:
                for m in t.model.modules():
                    if isinstance(m, mutils.Dropout):
                        m.p = m.configured_p
                held.pop("handed")
                batch = next(iter(t.data_loaders["train"]))
                _, losses = t.train_forward_backward(t._annotate_batch(
                    to_device(batch, t.device), t.global_step))
                held["shares"] = {k: float(v) for k, v in losses.items()}
                mp_dump(spec, t, held, "dropout")
            return results

        t.run = run_and_dump
        return t

    tbuild.build_trainer = build
    _build.reset_launches()


def mp_dump(spec, trainer, held, tag):
    """One rank's results (``<tag>_r<rank>.json``): its rows, eval metrics,
    launches, peak memory, collective times and stage stamps; the largest
    difference of its replicated parameters from rank 0's and of its head
    rows from its columns of the gathered head (both must be 0), of the
    step's summed replicated gradients from its mp group's first rank's,
    and the world's dropout streams. For ``tag`` "frozen" rank 0 also
    writes ``frozen.pt`` (phase_ddp's layout: the gathered state, the
    step-1 gradient before the clip, the parameters' LRs) with the clipped
    gradient beside it."""
    import hashlib

    import torch
    import torch.distributed as dist

    from sceneverse_tpu_torch.modules.utils import _streams
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.parallel import mesh, vocab

    torch.cuda.synchronize()
    r, model = mesh.rank(), trainer.model
    named = list(model.named_parameters())
    diffs = {"replicas": 0.0, "rows": 0.0, "peer_grad_abs": 0.0,
             "peer_grad_l2": 0.0}
    whole = {}
    for n, p in named:
        whole[n] = p.detach()
        if vocab.is_split(p):
            whole[n] = vocab.full_tensor(p.detach())
            k, v = mesh.mp_rank(), p.shape[0]
            diffs["rows"] = max(diffs["rows"], float(
                (whole[n][k * v:(k + 1) * v] - p).abs().max()))
    rep = torch.cat([p.detach().float().reshape(-1) for _, p in named
                     if not vocab.is_split(p)])
    ref = rep.clone()
    dist.broadcast(ref, 0)
    diffs["replicas"] = float((rep - ref).abs().max())
    h = held["handed"]
    first = h.clone()
    dist.broadcast(first, mesh.dp_rank() * mesh.mp_world(),
                   group=mesh.group("mp"))
    diffs["peer_grad_abs"] = float((h - first).abs().max())
    diffs["peer_grad_l2"] = float((h - first).norm()
                                  / first.norm().clamp_min(1e-30))
    t = torch.tensor(list(diffs.values()), device=trainer.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    gens = [hashlib.sha1(g.get_state().cpu().numpy().tobytes()).hexdigest()
            for g in _streams(model)]
    stamps = dict(held["stamps"], dumped=time.time())
    info = {"rank": r, "world": mesh.world(), "dp": mesh.dp_world(),
            "mp": mesh.mp_world(), "device": str(trainer.device),
            "launches": {k: v for k, v in _build.LAUNCHES.items() if v},
            "rows": trainer.history["train"],
            "val": (trainer.history["val"] or [{}])[-1],
            "test": trainer.history["test"][-1],
            "eval_batches": sum(len(ld) for s in ("val", "test")
                                if trainer.history[s]
                                for ld in eval_loaders(trainer, s)),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "split": list(trainer.vocab_split),
            "ckpt": str(trainer.ckpt_path / "best.pth"),
            "diffs": dict(zip(diffs, t.tolist())),
            "streams": mesh.all_gather_objects(gens, "world"),
            "collective_ms": {k: [s.elapsed_time(e) for s, e in v]
                              for k, v in held["events"].items()},
            "stamps": stamps, "shares": held.get("shares")}
    held["events"].clear()
    if r == 0 and tag == "frozen":
        lrs = {id(p): g["base_lr"] for g in trainer.optimizer.opt.param_groups
               for p in g["params"]}
        torch.save({"grad": held["grad"], "clipped": held["clipped"],
                    "stats1": held["stats1"],
                    "state": {**{k: v.cpu() for k, v in
                                 model.state_dict().items()},
                              **{n: v.cpu() for n, v in whole.items()}},
                    "lr": {n: lrs.get(id(p)) for n, p in named}},
                   os.path.join(spec["out"], "frozen.pt"))
    with open(os.path.join(spec["out"], f"{tag}_r{r}.json"), "w") as f:
        json.dump(info, f)


def _mp_world(name):
    """One world of MP_WORLDS through ``launch_torch.py --mode spmd``: its
    ranks' results and the launch's host-clock seconds; a non-zero exit
    (or one past MP_TIMEOUT_S) fails the phase."""
    import shutil

    n, mp, extra = MP_WORLDS[name]
    out = os.path.join(REPO, "build", "smoke_mp", name)
    shutil.rmtree(out, ignore_errors=True)
    hook = os.path.join(REPO, "build", "smoke_mp", "hook")
    os.makedirs(out)
    os.makedirs(hook, exist_ok=True)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(MP_HOOK)
    spec = {"repo": REPO, "out": out, "dropout_step": name == "w4_mp2"}
    base, over, _, _ = DDP_RUNS["frozen"]
    assert base is None
    cmd = [sys.executable, os.path.join(REPO, "launch_torch.py"), "--mode",
           "spmd", "--nproc-per-node", str(n), "--port", str(_free_port()),
           "--config", os.path.join(REPO, "configs", "final",
                                    "synthetic_pretrain.yaml"),
           *SLICE_ARGS[4:], "solver.log_every=1", *over, *extra,
           "device=cuda:0", "dist_backend=gloo", f"parallel.mp={mp}",
           f"base_dir={out}"]
    env = dict(os.environ, SCENEVERSE_MP_CHILD=json.dumps(spec),
               PYTHONPATH=os.pathsep.join(
                   [hook] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    t0 = time.time()
    with open(os.path.join(out, "launch.log"), "w") as logf:
        proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=logf,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            proc.wait(timeout=MP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.terminate()  # torch.distributed.run stops its workers
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)
                proc.wait()
    t1 = time.time()
    if proc.returncode != 0:
        with open(os.path.join(out, "launch.log")) as f:
            log(f"[mp] {name} log tail:\n" + "".join(f.readlines()[-60:]))
        raise AssertionError(f"[mp] {name}: launch_torch.py exited "
                             f"{proc.returncode}")
    ranks = {}
    for tag in ("frozen", "dropout") if spec["dropout_step"] else ("frozen",):
        ranks[tag] = []
        for r in range(n):
            with open(os.path.join(out, f"{tag}_r{r}.json")) as f:
                ranks[tag].append(json.load(f))
    for r in ranks["frozen"]:  # stages on the host clock, from the launch
        r["stages_s"] = {k: round(v - t0, 2) for k, v in r["stamps"].items()}
    return out, ranks, t1 - t0


def _mp_ckpt_into_world_of_1(path, want):
    """(b)'s checkpoint loaded into the model of a world of 1 (built on the
    meta device, then given cuda:0 storage, every tensor from the file):
    every tensor loaded, the head whole, the model equal to the file's and
    the file's to (b) rank 0's gathered state; the file's AdamW moments of
    the head whole."""
    import torch

    from sceneverse_tpu_torch.ckpt.checkpoint import load_checkpoint
    from sceneverse_tpu_torch.ckpt.convert import load_torch_pretrain
    from sceneverse_tpu_torch.model import build_model

    run_torch = __import__("run_torch")
    saved = load_checkpoint(path)
    with torch.device("meta"):
        model = build_model(run_torch.load_cfg(SLICE_ARGS))
    model = model.to_empty(device="cuda:0")
    loaded = load_torch_pretrain(model, path)
    state = model.state_dict()
    bad = [k for k, v in saved["model"].items()
           if not torch.equal(state[k].cpu(), v)]
    bad += [k for k, v in want.items()
            if not torch.equal(saved["model"][k], v)]
    head = list(state[MP_HEAD[1]].shape)
    # the AdamW moments of the vocabulary's size, whole or a split's rows
    # (the word embeddings' too)
    moments = sorted(list(v.shape) for s in saved["optimizer"]["opt"][
        "state"].values() for k, v in s.items()
        if k == "exp_avg" and v.shape[0] in (head[0], head[0] // 2))
    del model, state, saved
    _free()
    return {"tensors": loaded, "of": len(want), "head": head,
            "head_moments": moments, "unequal": bad}


def phase_mp(card):
    """The dp x mp grid on the one card (MP_WORLDS through
    ``launch_torch.py --mode spmd``), after ``phase_ddp``, whose world of 1
    is the reference: per-step losses, the step-1 gradients before and
    after the clip with the head gathered, the parameters after AdamW and
    the eval metrics within DDP_TOL["frozen"]; every replicated parameter
    bit-equal across the ranks and each rank's head rows bit-equal to its
    columns of the gathered head (also after (b)'s dropout step); the mp
    peers' summed gradients within MP_PEER_TOL and, with dropout on, their
    streams equal and the dp ranks' apart; every kernel of the frozen path
    launched on every rank; (b)'s ``best.pth`` into a world of 1. Prints
    each rank's host-clock steps and the collectives' CUDA-event times."""
    import torch

    t_phase = time.perf_counter()
    ref_dir = os.path.join(REPO, "build", "smoke_ddp", "w1_nccl")
    with open(os.path.join(ref_dir, "frozen_r0.json")) as f:
        ref = [json.load(f)]
    a = torch.load(os.path.join(ref_dir, "frozen.pt"), weights_only=True)
    clip = 5.0  # synthetic_pretrain's solver.grad_norm
    norm = a["grad"].double().norm()
    ref_clipped = a["grad"].double() * min(1.0, clip / float(norm))
    del a
    out, failed = {"grad_norm": float(norm), "clip_engaged":
                   bool(norm >= clip), "worlds": {}}, {}
    for name, (n, mp, _) in MP_WORLDS.items():
        wdir, ranks, seconds = _mp_world(name)
        tag = f"[mp {name}]"
        bad = {}
        for r in ranks["frozen"]:
            where = f"rank {r['rank']}"
            st = [row["step_s"] for row in r["rows"]]
            log(f"{tag} {where} of {r['world']} (dp {r['dp']} x mp "
                f"{r['mp']}) on {r['device']}: losses "
                f"{[round(row['total_loss'], 6) for row in r['rows']]}, "
                f"step_s {[round(s, 4) for s in st]} (host clock), eval "
                f"batches {r['eval_batches']}, peak "
                f"{r['peak_mem_gib']:.2f} GiB, stages {r['stages_s']} s; "
                "collectives (CUDA events, mean ms x calls) " + ", ".join(
                    f"{k} {statistics.mean(v):.3f} x {len(v)}"
                    for k, v in r["collective_ms"].items() if v)
                + f"  [{card}]")
            missing = [k for k in PATHS["frozen"][1]
                       if r["launches"].get(k, 0) <= 0]
            if missing:
                bad[f"{where} never launched"] = missing
            if tuple(r["split"]) != MP_HEAD:
                bad[f"{where} split"] = r["split"]
        for step_tag, rs in ranks.items():
            d = rs[0]["diffs"]
            if d["replicas"] != 0.0 or d["rows"] != 0.0:
                bad[f"{step_tag}: replicas / head rows not exact"] = d
            if d["peer_grad_l2"] > MP_PEER_TOL:
                bad[f"{step_tag}: mp peers' summed gradients"] = d
            log(f"{tag} {step_tag}: replicas max diff {d['replicas']}, head "
                f"rows {d['rows']}, mp peers' summed gradients before the "
                f"broadcast {d['peer_grad_abs']:.3g} abs / "
                f"{d['peer_grad_l2']:.3g} rel L2")
        if "dropout" in ranks:
            streams = ranks["dropout"][0]["streams"]
            peers = all(streams[r] == streams[r - r % mp] for r in range(n))
            apart = len({tuple(streams[r]) for r in range(0, n, mp)}) == \
                n // mp
            if not (peers and apart):
                bad["dropout streams"] = streams
            shares = [r["shares"]["lm_cls_loss"] for r in ranks["dropout"]]
            log(f"{tag} dropout step: each rank's lm_cls_loss share "
                f"{[round(x, 6) for x in shares]}; mp peers' streams equal "
                f"{peers}, dp ranks' apart {apart}")
        err, errs, worst = _ddp_compare("frozen", ref_dir, wdir, ref,
                                        ranks["frozen"])
        b = torch.load(os.path.join(wdir, "frozen.pt"), weights_only=True)
        got = b["clipped"].double()
        err["clipped_l2"] = float((got - ref_clipped).norm()
                                  / ref_clipped.norm())
        if not err["clipped_l2"] <= DDP_TOL["frozen"]["grad_l2"]:
            errs["clipped_l2"] = err["clipped_l2"]
        bad.update(errs)
        log(f"{tag} against phase_ddp's world of 1: " + ", ".join(
            f"{k} {v:.3g}" for k, v in err.items()) + f" (tol "
            f"{DDP_TOL['frozen']}, clipped_l2 at grad_l2's); largest "
            f"parameter difference in {worst}")
        entry = {"seconds": seconds, "errors": err, "worst_param": worst,
                 "ranks": {tag: [{k: r[k] for k in (
                     "rank", "launches", "rows", "val", "test", "diffs",
                     "peak_mem_gib", "collective_ms", "stamps")
                     if k in r} for r in rs] for tag, rs in ranks.items()},
                 "stages_s": [r["stages_s"] for r in ranks["frozen"]]}
        if name == "w4_mp2":
            want = {k: v for k, v in b["state"].items()}
            entry["ckpt"] = _mp_ckpt_into_world_of_1(
                ranks["frozen"][0]["ckpt"], want)
            c = entry["ckpt"]
            if (c["unequal"] or c["tensors"] != c["of"]
                    or c["head"][0] != 30522 or [30522] not in
                    c["head_moments"]
                    or any(m[0] != 30522 for m in c["head_moments"])):
                bad["checkpoint into a world of 1"] = c
            log(f"{tag} best.pth into a world of 1: {c['tensors']} of "
                f"{c['of']} tensors loaded and equal, head {c['head']}, its "
                f"moments {c['head_moments']}")
        del b
        log(f"{tag} {n} processes through launch_torch.py --mode spmd in "
            f"{seconds:.1f} s (host clock, process starts included)  "
            f"[{card}]")
        if bad:
            failed[name] = bad
        out["worlds"][name] = entry
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mp] step-1 gradient norm {out['grad_norm']:.4g} (clip at {clip}: "
        f"{'engaged' if out['clip_engaged'] else 'not engaged'}); phase took "
        f"{out['seconds']:.1f} s  [{card}]")
    if failed:
        raise AssertionError(f"[mp] failed: {failed}")
    return out


# ------------------------------------------------------------ model variants
# OpenVocab at SLICE_ARGS width with model.grounding replaced by each
# grounding variant (their decoder layers run the fused attention as
# cross-attention: 80 object queries over 50 text keys, and in V1 also 50
# over 80), and with the CLIP text tower as model.language (its 77
# positions take the 50-token utterance; no scene caption, all_noscene's
# losses); then the PointNet++ variant library at VoteNet's and PointNet++
# MSG's sizes. Each run: (train steps, eval batches).
VARIANT_GROUNDING_ARGS = {"hidden_size": 768, "num_attention_heads": 12,
                          "spatial_dim": 5, "num_layers": 4, "dim_loc": 6,
                          "pairwise_rel_type": "center"}
VARIANT_GROUNDINGS = {"variant_entity": "EntitySpatialCrossEncoder",
                      "variant_v1": "UnifiedSpatialCrossEncoderV1"}
VARIANT_STEPS = {"variant_entity": (3, 2), "variant_v1": (3, 2),
                 "variant_clip": (2, 1)}
# fused attention layers a grounding layer holds: V2 its self-attention;
# the spatial decoder its 'cond' self-attention and its cross-attention; V1
# that and the text decoder's self- and cross-attention
GROUNDING_ATTN = {"UnifiedSpatialCrossEncoderV2": 1,
                  "EntitySpatialCrossEncoder": 2,
                  "UnifiedSpatialCrossEncoderV1": 4}
# openai/clip-vit-large-patch14's text tower (CLIPTextConfig's defaults:
# 12 layers, 768 wide, FFN 3072, 49408 words, 77 positions), random weights
CLIP_LANGUAGE = {"name": "CLIPLanguageEncoder", "lr": 1e-5,
                 "args": {"weights": "openai/clip-vit-large-patch14",
                          "output_dim": 768, "freeze_backbone": True,
                          "num_hidden_layers": 12}}
CLIP_LOSSES = ["lm_cls_loss", "TextObjWithinBatch"]  # all_noscene.yaml
# VoteNet's backbone (Qi et al., ICCV 2019, models/backbone_module.py): 20k
# points with a height feature, four SA levels (npoint, radius, nsample,
# mlp, normalize_xyz) and two FP levels; PointNet++'s MSG classification
# SA1 on 1024-point clouds; the LFP module propagates its output back
VOTENET = {"batch": 8, "points": 20000,
           "sa": [(2048, 0.2, 64, [1, 64, 64, 128], True),
                  (1024, 0.4, 32, [128, 128, 128, 256], False),
                  (512, 0.8, 16, [256, 128, 128, 256], False),
                  (256, 1.2, 16, [256, 128, 128, 256], False)],
           "fp": [[512, 256, 256], [512, 256, 256]]}
MSG_CLS = {"batch": 16, "points": 1024, "npoint": 512,
           "radii": [0.1, 0.2, 0.4], "nsamples": [16, 32, 128],
           "mlps": [[0, 32, 32, 64], [0, 64, 64, 128], [0, 64, 96, 128]],
           "lfp_mlps": [[320, 64, 128], [320, 64, 128], [320, 128, 128]],
           "lfp_post": [128, 128]}
# the variant modules on the card against the same modules on the CPU, on
# max|card - cpu| / max|cpu|: float64 on both sides (in f32 a max-pool or a
# ReLU within rounding of a tie may go the other way, moving one gradient
# row whole); f32 forward values within TOL["f32"]; indices exactly. The
# CPU runs the first PNET_CPU_CLOUDS clouds of each batch: its plain ball
# query over VoteNet's (8, 2048, 20000) pairs alone took about a minute
PNET_TOL = 1e-4
PNET_CPU_CLOUDS = 2


def variant_cfg(name):
    """The SLICE_ARGS config with the run's grounding or language tower."""
    import run_torch

    cfg = run_torch.load_cfg(SLICE_ARGS + [
        f"exp_dir={os.path.join(REPO, 'build', 'smoke_runs', name)}"])
    if name == "variant_clip":
        cfg.model.language = json.loads(json.dumps(CLIP_LANGUAGE))
        cfg.data.args.use_scene_cap = False
        cfg.model.loss_list = list(CLIP_LOSSES)
        cfg.model.vis_loss_list = list(CLIP_LOSSES)
    else:
        cfg.model.grounding = {"name": VARIANT_GROUNDINGS[name], "lr": 1e-4,
                               "args": dict(VARIANT_GROUNDING_ARGS)}
    return cfg


def variant_attn_per_forward(cfg):
    """``mha_fwd`` launches of one ``OpenVocab`` forward, from the config:
    the spatial encoder's layers, the BERT utterance tower's, the split
    caption tower's but for its ``cls_only`` last layer (plain), and the
    grounding's fused layers (``GROUNDING_ATTN``). CLIP takes no fused
    attention. Every one of them trains, so a train step launches as many
    ``mha_bwd``."""
    from sceneverse_tpu_torch.model.openvocab import cap_cls_only_enabled

    m = cfg.model
    n = int(m.vision.args.num_layers)
    if m.language.name == "BERTLanguageEncoder":
        lang = int(m.language.args.num_hidden_layers)
        n += lang
        if cfg.data.args.get("use_scene_cap") and m.get(
                "split_scene_cap_tower"):
            n += lang - 1 if cap_cls_only_enabled() else lang
    return n + GROUNDING_ATTN[m.grounding.name] * int(
        m.grounding.args.num_layers)


def _variant_run(name):
    """One variant through ``build_trainer``: VARIANT_STEPS train steps
    (forward, losses, backward, AdamW) and eval batches, their launches
    exact, the losses finite and moving, the og3d logits finite; the peak
    memory of the train steps and one more step's device time."""
    import torch

    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.trainer.build import build_trainer, to_device

    tag = f"[{name}]"
    cfg = variant_cfg(name)
    n_train, n_eval = VARIANT_STEPS[name]
    t0 = time.perf_counter()
    trainer = build_trainer(cfg)
    dev = trainer.device
    train = [to_device(b, dev) for b, _ in
             zip(trainer.data_loaders["train"], range(n_train))]
    evals = [to_device(b, dev) for b, _ in
             zip(eval_loaders(trainer, "val")[0], range(n_eval))]
    per_fwd = variant_attn_per_forward(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses = []
    for i, b in enumerate(train):
        _, step = trainer.train_forward_backward(trainer._annotate_batch(b, i))
        losses.append({k: float(v.detach()) for k, v in step.items()})
    train_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _build.reset_launches()
    outs = [trainer.forward(b)["og3d_logits"] for b in evals]
    eval_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    total = [r["total_loss"] for r in losses]
    log(f"{tag} {cfg.model.language.name} + {cfg.model.grounding.name}: "
        f"{n_train} train steps, losses {[round(x, 5) for x in total]} "
        f"({losses[-1]}); launches {train_launches} ({per_fwd} mha_fwd and "
        f"mha_bwd a step); {n_eval} eval batches: launches {eval_launches} "
        f"({per_fwd} mha_fwd a batch); peak memory {peak:.2f} GiB")
    want_train = {"fps": 2 * n_train, "sa_group_mlp_pool": 2 * n_train,
                  "mha_fwd": per_fwd * n_train, "mha_bwd": per_fwd * n_train}
    want_eval = {"fps": 2 * n_eval, "sa_group_mlp_pool": 2 * n_eval,
                 "mha_fwd": per_fwd * n_eval}
    if train_launches != want_train or eval_launches != want_eval:
        raise AssertionError(f"{tag} launches {train_launches} / "
                             f"{eval_launches}, expected {want_train} / "
                             f"{want_eval}")
    if not (all(math.isfinite(x) for r in losses for x in r.values())
            and len(set(total)) == n_train):
        raise AssertionError(f"{tag} losses not finite or not moving: {total}")
    shape = (int(cfg.dataloader.batchsize), int(cfg.data.args.max_obj_len))
    for o in outs:
        if tuple(o.shape) != shape or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{tag} og3d {tuple(o.shape)} not finite")
    info = {"train_losses": losses, "train_launches": train_launches,
            "eval_launches": eval_launches, "mha_per_forward": per_fwd,
            "peak_mem_gib": peak,
            "launches": dict(collections.Counter(train_launches)
                             + collections.Counter(eval_launches))}
    if name == "variant_entity":  # the geometry port's 'vertical_bottom'
        enc = trainer.model.unified_encoder
        enc.pairwise_rel_type = "vertical_bottom"
        _build.reset_launches()
        vb = trainer.forward(evals[0])["og3d_logits"]
        vb_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        enc.pairwise_rel_type = "center"
        center = trainer.forward(evals[0])["og3d_logits"]
        diff = (vb - center).abs().max().item()
        log(f"{tag} vertical_bottom forward: og3d finite "
            f"{bool(torch.isfinite(vb).all())}, max|vertical_bottom - "
            f"center| {diff:.4g}, launches {vb_launches}")
        if not (bool(torch.isfinite(vb).all()) and diff > 0
                and vb_launches.get("mha_fwd") == per_fwd):
            raise AssertionError(f"{tag} vertical_bottom forward {diff} "
                                 f"{vb_launches}")
        info["vertical_bottom_vs_center"] = diff
    step_ms, events = kernel_sum_ms(
        lambda: trainer.train_forward_backward(train[0]))
    info.update({"step_device_ms": step_ms, "step_device_events": events,
                 "seconds": time.perf_counter() - t0})
    log(f"{tag} one train step: {step_ms:.3f} ms of device work ({events} "
        f"device events, torch.profiler); run {info['seconds']:.1f} s")
    del trainer, train, evals, outs
    _free()
    return info


def votenet_backbone():
    """VoteNet's backbone forward (``VOTENET``) from the port's
    ``PointnetSAModuleVotes`` and ``PointnetFPModule``: returns the second
    FP level's features (B, 1024, 256) and the four levels' FPS indices."""
    from torch import nn

    from sceneverse_tpu_torch.modules.layers.pointnet import (
        PointnetFPModule, PointnetSAModuleVotes)

    class Backbone(nn.Module):
        def __init__(self):
            super().__init__()
            self.sa = nn.ModuleList([
                PointnetSAModuleVotes(mlp=mlp, npoint=n, radius=r, nsample=s,
                                      normalize_xyz=norm)
                for n, r, s, mlp, norm in VOTENET["sa"]])
            self.fp = nn.ModuleList([PointnetFPModule(mlp=m)
                                     for m in VOTENET["fp"]])

        def forward(self, pc):
            xyz, feats = pc[..., :3].contiguous(), pc[..., 3:]
            levels, inds = [], []
            for sa in self.sa:
                xyz, feats, ind = sa(xyz, feats)
                levels.append((xyz, feats))
                inds.append(ind)
            (x2, f2), (x3, f3), (x4, f4) = levels[1:]
            f = self.fp[0](x3, x4, f3, f4)
            return self.fp[1](x2, x3, f2, f), inds

    return Backbone()


def _pnet_modules(gen):
    """(name, module, inputs, call) of the four variant cases, built on the
    CPU from ``gen``: seeded convs (``init_pointnet_weights``) and random
    eval-mode BatchNorm statistics and affines; ``call(module, *inputs)``
    returns (the values compared, the indices compared)."""
    import torch

    from sceneverse_tpu_torch.modules.layers.pointnet import (
        PointnetLFPModuleMSG, PointnetSAModuleMSG, PointnetSAModuleMSGVotes,
        init_pointnet_weights)

    def ready(m):
        init_pointnet_weights(m, gen)
        with torch.no_grad():
            for mod in m.modules():
                if isinstance(mod, torch.nn.BatchNorm1d):
                    c = mod.num_features
                    mod.running_mean.copy_(torch.randn(c, generator=gen)
                                           * 0.1)
                    mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
                    mod.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                    mod.bias.copy_(torch.randn(c, generator=gen) * 0.1)
        return m.eval()

    B, P = VOTENET["batch"], VOTENET["points"]
    room = torch.rand((B, P, 3), generator=gen) * torch.tensor([6.0, 6.0,
                                                                2.5])
    room[..., :2] -= 3.0
    pc = torch.cat([room, room[..., 2:]], -1)  # xyz, height above the floor
    Bc, Pc = MSG_CLS["batch"], MSG_CLS["points"]
    cloud = torch.randn((Bc, Pc, 3), generator=gen)
    cloud = cloud / cloud.norm(dim=-1, keepdim=True) * torch.rand(
        (Bc, Pc, 1), generator=gen) ** (1 / 3)  # in the unit ball
    kw = {k: MSG_CLS[k] for k in ("npoint", "radii", "nsamples", "mlps")}
    msg = ready(PointnetSAModuleMSG(**kw))
    with torch.no_grad():
        centers, feats1 = msg(cloud, None)
    lfp = ready(PointnetLFPModuleMSG(
        mlps=MSG_CLS["lfp_mlps"], radii=MSG_CLS["radii"],
        nsamples=MSG_CLS["nsamples"], post_mlp=MSG_CLS["lfp_post"]))
    votenet = ready(votenet_backbone())
    msg_votes = ready(PointnetSAModuleMSGVotes(**kw))
    return [
        ("votenet_backbone", votenet, [pc], lambda m, x: m(x)),
        ("sa_msg", msg, [cloud], lambda m, x: (m(x, None)[1], [])),
        ("sa_msg_votes", msg_votes, [cloud],
         lambda m, x: (lambda o: (o[1], [o[2]]))(m(x, None))),
        ("lfp_msg", lfp, [cloud, centers, feats1],
         lambda m, x2, x1, f1: (m(x2, x1, None, f1), [])),
    ]


def _pnet_index_hooks(module, store):
    """Forward hooks recording each SA / FP call's point sets, from which
    ``_pnet_indices`` recomputes the ball-query and 3-NN indices."""
    from sceneverse_tpu_torch.modules.layers import pointnet as pn

    def sa_hook(mod, args, out):
        if isinstance(mod, pn.PointnetSAModuleVotes):
            scales = [(mod.radius, mod.nsample)]
        else:
            msg = getattr(mod, "msg", mod)
            scales = list(zip(msg.radii, msg.nsamples))
        if out[0] is not None:
            store.append(("ball", args[0].detach(), out[0].detach(), scales))

    def fp_hook(mod, args, out):
        if args[1] is not None:
            store.append(("3nn", args[0].detach(), args[1].detach(), None))

    def lfp_hook(mod, args, out):
        store.append(("ball", args[1].detach(), args[0].detach(),
                      list(zip(mod.radii, mod.nsamples))))

    hooks = []
    for m in module.modules():
        if isinstance(m, (pn.PointnetSAModuleVotes, pn.PointnetSAModuleMSG,
                          pn.PointnetSAModuleMSGVotes)):
            hooks.append(m.register_forward_hook(sa_hook))
        elif isinstance(m, pn.PointnetFPModule):
            hooks.append(m.register_forward_hook(fp_hook))
        elif isinstance(m, pn.PointnetLFPModuleMSG):
            hooks.append(m.register_forward_hook(lfp_hook))
    return hooks


def _pnet_indices(store):
    """The ball-query and 3-NN indices of every recorded call."""
    from sceneverse_tpu_torch.ops.pointops import ball_query, three_nn

    out = []
    for kind, pts, ctr, scales in store:
        if kind == "ball":
            out += [ball_query(r, s, pts, ctr) for r, s in scales]
        else:
            out.append(three_nn(pts, ctr)[1])
    return out


def _pnet_case(name, module, inputs, call):
    """One variant module on the card against its copy on the CPU, which
    runs the first PNET_CPU_CLOUDS clouds of the batch (in eval mode each
    cloud's outputs and gradients depend on its own points alone): f32
    forward (no gradients): the FPS indices it returns and the ball-query
    / 3-NN indices of each of its levels equal, the values within
    TOL["f32"]; float64 forward and backward (of the outputs' sum): values
    and the inputs' gradients within PNET_TOL; the whole batch's f32
    forward + backward time on the card (CUDA events, median of 3)."""
    import copy

    import torch

    dev = torch.device("cuda")
    n = PNET_CPU_CLOUDS
    card = copy.deepcopy(module).to(dev)
    sides = (("cpu", module, torch.device("cpu"), [t[:n] for t in inputs]),
             ("card", card, dev, inputs))
    res, idx, vals, grads = {}, {}, {}, {}
    for side, mod, d, ins in sides:
        store = []
        hooks = _pnet_index_hooks(mod, store)
        with torch.no_grad():
            v, inds = call(mod, *[t.to(d) for t in ins])
        for h in hooks:
            h.remove()
        idx[side] = [t[:n].cpu() for t in list(inds) + _pnet_indices(store)]
        vals[side] = v[:n].cpu()
    same = len(idx["cpu"]) == len(idx["card"]) and all(
        torch.equal(a, b) for a, b in zip(idx["cpu"], idx["card"]))
    err, scale = _err(vals["card"], vals["cpu"])
    res["f32_rel_err"] = err / max(scale, 1e-30)
    res["index_sets"] = len(idx["cpu"])
    res["shape"] = list(v.shape)
    for side, mod, d, ins in sides:
        mod.double()
        leaves = [t.detach().double().to(d).requires_grad_() for t in ins]
        out, _ = call(mod, *leaves)
        out.sum().backward()
        vals[side] = out.detach()[:n].cpu()
        grads[side] = [t.grad[:n].cpu() for t in leaves]
        mod.float()
    rel = [_err(vals["card"], vals["cpu"])]
    rel += [_err(a, b) for a, b in zip(grads["card"], grads["cpu"])]
    res["f64_rel_err"] = max(e / max(s, 1e-30) for e, s in rel)
    leaves = [t.detach().to(dev).requires_grad_() for t in inputs]

    def fwd_bwd():
        out, _ = call(card, *leaves)
        out.sum().backward()

    res["card_ms"] = cuda_ms(fwd_bwd, reps=3)
    log(f"[pnet {name}] out {tuple(res['shape'])}, CPU on {n} clouds: "
        f"{res['index_sets']} index sets (FPS, ball query, 3-NN) equal card "
        f"vs CPU: {same}; f32 forward max_rel_err {res['f32_rel_err']:.3e} "
        f"(tol {TOL['f32']:g}); f64 forward + input gradients max_rel_err "
        f"{res['f64_rel_err']:.3e} (tol {PNET_TOL:g}); f32 forward + "
        f"backward on the card {res['card_ms']:.3f} ms")
    if not (same and res["f32_rel_err"] <= TOL["f32"]
            and res["f64_rel_err"] <= PNET_TOL):
        raise AssertionError(f"[pnet {name}] card differs from the CPU: {res}")
    del card, leaves
    _free()
    return res


def phase_variants():
    """The model variants on the card: the two grounding variants and the
    CLIP language tower in ``OpenVocab`` at SLICE_ARGS width
    (``_variant_run``), then the PointNet++ variant modules (``_pnet_case``);
    launches of each path for the kernel line (the PointNet++ variants run
    plain PyTorch: no kernel)."""
    import torch

    from sceneverse_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    out = {"runs": {name: _variant_run(name) for name in VARIANT_STEPS}}
    gen = torch.Generator().manual_seed(18)
    _build.reset_launches()
    out["pointnet"] = {name: _pnet_case(name, *rest)
                       for name, *rest in _pnet_modules(gen)}
    out["pointnet_launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
    if out["pointnet_launches"]:
        raise AssertionError("the PointNet++ variants launched "
                             f"{out['pointnet_launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[variants] phase took {out['seconds']:.1f} s")
    return out


PREPROCESS_SEED = 19
PREPROCESS_DIR = os.path.join(REPO, "build", "preprocess")
# one raw scan per processor at the scale of its release (ARKitScenes and
# Structured3D above the 240K cap, so that it runs)
PREPROCESS_SCANS = {
    "RScanProcessor": ("rscan", {"n_vertices": 200_000, "n_objects": 40}),
    "MultiScanProcessor": ("multiscan", {"n_vertices": 300_000,
                                         "n_faces": 600_000, "n_objects": 40}),
    "ARKitScenesProcessor": ("arkit", {"n_vertices": 1_000_000, "n_boxes": 30}),
    "Structured3DProcessor": ("s3d", {"n_points": 400_000, "n_boxes": 40}),
}
RSCAN_TEXTURE = (1024, 1024)
PREPROCESS_TOL = 1e-9
F64_PEAK = 34e12  # H100 SXM data sheet: FP64 outside the tensor cores


def write_raw_scans(root):
    """The four raw scans of PREPROCESS_SCANS under ``root``, from one
    seed."""
    import numpy as np

    from sceneverse_tpu_torch.preprocess import fixture

    rng = np.random.RandomState(PREPROCESS_SEED)
    raw = {name: os.path.join(root, sub)
           for name, (sub, _) in PREPROCESS_SCANS.items()}
    fixture.write_rscan_scan(raw["RScanProcessor"], "scan_rscan", rng,
                             texture=RSCAN_TEXTURE,
                             **PREPROCESS_SCANS["RScanProcessor"][1])
    fixture.write_multiscan_scan(raw["MultiScanProcessor"], "scene_00000_00",
                                 rng, **PREPROCESS_SCANS["MultiScanProcessor"][1])
    fixture.write_arkit_scan(raw["ARKitScenesProcessor"], "Training", "41069021",
                             rng, **PREPROCESS_SCANS["ARKitScenesProcessor"][1])
    fixture.write_s3d_scan(raw["Structured3DProcessor"], "train", "scene_00000",
                           rng, **PREPROCESS_SCANS["Structured3DProcessor"][1])
    return raw


def kdtree_nearest(query, ref, block_elems=None):
    """The nearest-vertex search of the JAX package's 3RScan processor
    (``processors.py:186-187``: one ``cKDTree`` query), on host tensors."""
    import torch
    from scipy.spatial import cKDTree

    dist, nn = cKDTree(ref.numpy()).query(query.numpy(), k=1)
    return torch.from_numpy(dist), torch.from_numpy(nn)


def _run_processor(name, raw, out, device):
    from sceneverse_tpu_torch.config import Config
    from sceneverse_tpu_torch.preprocess import processors

    t0 = time.perf_counter()
    proc = getattr(processors, name)(Config({
        "data_root": raw, "save_root": out, "num_workers": 1,
        "output": {"pcd": True}, "device": device, "seed": PREPROCESS_SEED}))
    proc.process_scans()
    return {"seconds": time.perf_counter() - t0,
            "device_pass_s": proc.device_seconds}


def _processed(out):
    """{relative path: content} of a processor's outputs, each ``.pth``
    loaded on the host as the data layer loads it."""
    import numpy as np
    import torch

    got = {}
    for base, _, files in os.walk(out):
        for f in files:
            path = os.path.join(base, f)
            rel = os.path.relpath(path, out)
            if f.endswith(".pth"):
                got[rel] = torch.load(path, weights_only=False)
            elif f.endswith(".npy"):
                got[rel] = float(np.load(path))
            else:
                got[rel] = open(path).read()
    return got


def _compare_processed(tag, got, want):
    """Instance ids, labels, angles and split files equal; vertices and
    colours within PREPROCESS_TOL; the arrays numpy on the host."""
    import numpy as np

    if got.keys() != want.keys():
        raise AssertionError(f"{tag}: outputs {sorted(got)} != {sorted(want)}")
    err = 0.0
    n_points = 0
    for key, ref in want.items():
        out = got[key]
        if "pcd_with_global_alignment" in key and key.endswith(".pth"):
            if not all(type(a) is np.ndarray for a in out):
                raise AssertionError(f"{tag} {key}: not numpy: "
                                     f"{[type(a) for a in out]}")
            (v, c, inst), (rv, rc, rinst) = out, ref
            if not np.array_equal(inst, rinst) or inst.dtype != rinst.dtype:
                raise AssertionError(f"{tag} {key}: instance ids differ at "
                                     f"{int((inst != rinst).sum())} points")
            if v.shape != rv.shape or c.shape != rc.shape:
                raise AssertionError(f"{tag} {key}: shapes differ")
            err = max(err, float(np.abs(v - rv).max()),
                      float(np.abs(c - rc).max()))
            n_points = len(v)
        elif out != ref:
            raise AssertionError(f"{tag} {key}: {out!r} != {ref!r}")
    if not err <= PREPROCESS_TOL:
        raise AssertionError(f"{tag}: vertices or colours differ by {err}")
    return err, n_points


def rscan_search_vs_kdtree(raw):
    """The card's nearest-vertex search against ``cKDTree`` on the 3RScan
    scan: indices that differ, of them the exact ties, and the instances a
    tie changes."""
    import numpy as np
    import torch

    from sceneverse_tpu_torch.preprocess import processors
    from sceneverse_tpu_torch.preprocess.mesh_io import load_ply

    scan = os.path.join(raw, "scan_rscan")
    verts, _ = processors._read_obj(os.path.join(scan, "mesh.refined.v2.obj"))
    label = load_ply(os.path.join(scan, "labels.instances.annotated.v2.ply"))
    ref = torch.from_numpy(label["vertices"].astype(np.float64))
    query = torch.from_numpy(verts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist, nn = processors.nearest_vertex(query.cuda(), ref.cuda())
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    kd_dist, kd_nn = kdtree_nearest(query, ref)
    dist, nn = dist.cpu(), nn.cpu()
    differ = (nn != kd_nn).nonzero().squeeze(1)
    ties = int((dist[differ] == kd_dist[differ]).sum())
    d_err = float((dist - kd_dist).abs().max())
    with open(os.path.join(scan, "mesh.refined.0.010000.segs.v2.json")) as f:
        seg = np.asarray(json.load(f)["segIndices"])
    changed = int((seg[nn[differ].numpy()] != seg[kd_nn[differ].numpy()]).sum())
    if len(differ) != ties or d_err > 1e-12:
        raise AssertionError(f"[preprocess] RScan search: {len(differ)} "
                             f"indices differ from cKDTree, {ties} of them "
                             f"ties; distances within {d_err}")
    pairs = len(verts) * len(ref)
    # 3 differences, 3 squares, 2 sums a pair; each input read once, the
    # distances and indices written once
    bound_s = max(8 * pairs / F64_PEAK,
                  (query.numel() + ref.numel() + 2 * len(verts)) * 8 / HBM_RATE)
    return {"pairs": pairs, "search_s": search_s, "bound_s": bound_s,
            "index_differs": len(differ), "ties": ties,
            "tie_segments_differ": changed, "max_dist_err": d_err}


def phase_preprocess(card):
    """The offline tools on the card: each processor on its raw scan with
    ``device="cuda"`` and ``device="cpu"`` from one seed (3RScan's CPU run
    with the JAX package's cKDTree search in place of the brute force, so
    the card is held against ``cKDTree``), outputs compared; then
    ``generate_ssg`` on the card's processed trees on both devices, JSON
    byte-equal. Launches none of the port's kernels."""
    import shutil

    import torch

    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.preprocess import processors
    from sceneverse_tpu_torch.preprocess.ssg.ssg_main import generate_ssg

    t_phase = time.perf_counter()
    shutil.rmtree(PREPROCESS_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    raw = write_raw_scans(os.path.join(PREPROCESS_DIR, "raw"))
    out = {"card": card, "write_s": time.perf_counter() - t0,
           "scans": {n: s[1] for n, s in PREPROCESS_SCANS.items()},
           "processors": {}, "ssg": {}}
    log(f"[preprocess] raw scans written in {out['write_s']:.1f} s")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    for name, (sub, _) in PREPROCESS_SCANS.items():
        trees = {d: os.path.join(PREPROCESS_DIR, d, sub) for d in ("cuda", "cpu")}
        row = {"cuda": _run_processor(name, raw[name], trees["cuda"], "cuda")}
        if name == "RScanProcessor":
            brute = processors.nearest_vertex
            processors.nearest_vertex = kdtree_nearest
            try:
                row["cpu"] = _run_processor(name, raw[name], trees["cpu"], "cpu")
            finally:
                processors.nearest_vertex = brute
            row["cpu"]["search"] = "cKDTree"
        else:
            row["cpu"] = _run_processor(name, raw[name], trees["cpu"], "cpu")
        row["max_abs_err"], row["points_saved"] = _compare_processed(
            f"[preprocess] {name}", _processed(trees["cuda"]),
            _processed(trees["cpu"]))
        out["processors"][name] = row
        log(f"[preprocess] {name}: cuda device pass "
            f"{row['cuda']['device_pass_s']:.3f} s, whole "
            f"{row['cuda']['seconds']:.3f} s; cpu device pass "
            f"{row['cpu']['device_pass_s']:.3f} s, whole "
            f"{row['cpu']['seconds']:.3f} s; card = cpu (max err "
            f"{row['max_abs_err']:.3g}, {row['points_saved']} points)  [{card}]")
        tree = os.path.join(trees["cuda"], "scan_data")
        ssg = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            rels, objs = generate_ssg(tree, os.path.join(trees["cuda"], f"ssg_{device}"),
                                      device=device, seed=PREPROCESS_SEED)
            ssg[device] = {"seconds": time.perf_counter() - t0,
                           "objects": sum(len(o) for o in objs.values()),
                           "relations": sum(len(r["relationships"])
                                            for r in rels.values())}
        for f in ("relationships.json", "objects.json"):
            files = [open(os.path.join(trees["cuda"], f"ssg_{d}", f), "rb").read()
                     for d in ("cuda", "cpu")]
            if files[0] != files[1]:
                raise AssertionError(f"[preprocess] {name}: ssg {f} differs "
                                     "between cuda and cpu")
        if not ssg["cuda"]["objects"] or not ssg["cuda"]["relations"]:
            raise AssertionError(f"[preprocess] {name}: empty scene graph {ssg}")
        out["ssg"][name] = ssg
        log(f"[preprocess] {name} ssg: cuda {ssg['cuda']['seconds']:.3f} s, "
            f"cpu {ssg['cpu']['seconds']:.3f} s, {ssg['cuda']['objects']} "
            f"objects, {ssg['cuda']['relations']} relations, JSON equal")
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launches:
        raise AssertionError(f"[preprocess] launched {launches}")
    out["rscan_search"] = rscan_search_vs_kdtree(raw["RScanProcessor"])
    log(f"[preprocess] RScan search vs cKDTree: {out['rscan_search']}")
    shutil.rmtree(PREPROCESS_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[preprocess] phase took {out['seconds']:.1f} s  [{card}]")
    return out


# ------------------------------------------------------------------ tools
TOOLS_DIR = os.path.join(REPO, "build", "smoke_tools")
# each tool at a small setting: the command and the metrics it must print
TOOL_RUNS = {
    "latency": (["bench_latency_torch.py", "--batches", "1,8", "--warmup",
                 "2", "--iters", "5"], {"gps_grounding_latency"}),
    "towers": (["bench_towers_torch.py", "--batch", "8", "--reps", "2"],
               {"gps_tower_device_ms"}),
    "pipeline": (["bench_pipeline_torch.py", "--steps", "2",
                  "--fixture-scans", "1", "--reps", "2"],
                 {"item_build_scenes_per_sec_per_core",
                  "materialized_feed_scenes_per_sec",
                  "loader_collate_scenes_per_sec",
                  "h2d_batch_transfer_mb_per_sec",
                  "trainer_loop_scenes_per_sec", "eval_loop_scenes_per_sec"}),
    "scale": (["bench_scale_torch.py", "--scans", "200", "--steps", "3",
               "--root", os.path.join(TOOLS_DIR, "scale")],
              {"scale_fixture_write", "scale_scanbase_full_load",
               "scale_store_build", "scale_store_open",
               "scale_feed_scenes_per_sec", "scale_feed_dp8_scenes_per_sec"}),
    "caplen": (["bench_caplen_torch.py"], {"scene_cap_token_length"}),
}
TOWERS = ("lang_fused_2B", "lang_txt_only", "lang_cap_only", "vision_tower",
          "pointnet_backbone", "unified_encoder", "pretrain_head")
# the frozen eval path's kernels, which the latency and towers tools' model
# and the pipeline tool's trainer launch
TOOL_KERNELS = ("fps", "sa_group_mlp_pool", "mha_fwd")
TOOLS_TIMEOUT_S = 400


def _positive(tag, rec, keys):
    for k in keys:
        v = rec[k]
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            raise AssertionError(f"[tools] {tag}: {k} = {v!r} is not a "
                                 f"finite positive number: {rec}")


def _check_tool(name, lines, card):
    """Every expected line is there, parses, names this card and holds
    finite positive values; the kernels of the path launched."""
    metrics = {r["metric"] for r in lines}
    if metrics != TOOL_RUNS[name][1]:
        raise AssertionError(f"[tools] {name} printed {sorted(metrics)}, "
                             f"expected {sorted(TOOL_RUNS[name][1])}")
    for r in lines:
        dev = r["device"]
        if not ("H100" in dev["name"] and card.startswith(dev["name"])
                and dev["power_limit"] in card and dev["driver"]
                and dev["cuda"] and dev["torch"]
                and dev["clock"] == "cuda_events"):
            raise AssertionError(f"[tools] {name}: device record {dev} does "
                                 f"not name this card ({card})")
        tag = f"{name} {r['metric']}"
        if name == "latency":
            _positive(tag, r, ("p50_ms", "p90_ms", "device_ms_est",
                               "device_ms_min", "device_ms_max"))
            missing = [k for k in TOOL_KERNELS
                       if not r["launches_per_call"].get(k)]
            assert not missing, f"[tools] {tag}: no launch of {missing}"
        elif name == "towers":
            _positive(tag, r, TOWERS)
            _positive(tag, r["min_ms"], TOWERS)
            missing = [k for k in TOOL_KERNELS if not r["launches"].get(k)]
            assert not missing, f"[tools] {tag}: no launch of {missing}"
        elif name == "caplen":
            _positive(tag, r, ("p50", "p90", "p95", "max", "n"))
            assert 0 <= r["truncated_pct"] <= 100, r
        else:
            _positive(tag, r, ("value",))
            if r["metric"] == "trainer_loop_scenes_per_sec":
                _positive(tag, r, ("step_median_ms", "epoch_median_ms"))
                missing = [k for k in TOOL_KERNELS + ("mha_bwd",)
                           if not r["launches"].get(k)]
                assert not missing, f"[tools] {tag}: no launch of {missing}"
            if r["metric"] == "scale_feed_dp8_scenes_per_sec":
                assert (r["dp"], r["rows_per_rank"]) == (8, 16), r
                _positive(tag, r, ("h2d_median_ms", "rank_batch_mb"))
    if name == "pipeline":
        memories = sorted(r["memory"] for r in lines
                          if r["metric"] == "h2d_batch_transfer_mb_per_sec")
        assert memories == ["pageable", "pinned"], memories


def trainer_argmax_batch8():
    """``forward``'s og3d argmax of a trainer (the frozen slice's config at
    the latency tool's bf16, ``mode=test``) holding the latency tool's
    weights (its model rebuilt here from the same seed), on the tool's
    batch-8 batch."""
    import run_torch
    from bench_latency_torch import NUM_OBJ, NUM_POINTS, SEQ_LEN, build
    from sceneverse_tpu_torch.trainer.build import build_trainer, to_device
    from sceneverse_tpu_torch.utils.gps_inputs import gps_batch, gps_cfg

    trainer = build_trainer(run_torch.load_cfg(SLICE_ARGS + [
        "mode=test", "rng_seed=0", "mixed_precision=bf16",
        "data.synthetic_size=8", "dataloader.batchsize=8",
        f"exp_dir={os.path.join(TOOLS_DIR, 'trainer')}"]))
    tool_model = build(gps_cfg(), "cpu", seed=0)
    trainer.model.load_state_dict(tool_model.state_dict(), strict=True)
    del tool_model
    batch = to_device(gps_batch(8, NUM_OBJ, NUM_POINTS, SEQ_LEN),
                      trainer.device)
    got = trainer.forward(batch)["og3d_logits"].argmax(-1).tolist()
    del trainer
    return got


def phase_tools(card):
    """The port's measuring tools (``bench_*_torch.py``), each in its own
    process at a small setting, all five at once (the kernels are built),
    while this process takes the trainer's argmax that the latency tool's
    must equal; their lines checked."""
    import shutil

    t0 = time.time()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    env = dict(os.environ, SCENEVERSE_BENCH_FIXTURE=os.path.join(
        TOOLS_DIR, "bench_fixture"))
    procs = {}
    for name, (argv, _) in TOOL_RUNS.items():
        out = open(os.path.join(TOOLS_DIR, f"{name}.out"), "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, os.path.join(REPO, argv[0]), *argv[1:]],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT,
            text=True), out)
    results, seconds = {}, {}
    try:
        argmax = trainer_argmax_batch8()
        argmax_s = time.time() - t0
        while len(seconds) < len(procs):
            if time.time() - t0 > TOOLS_TIMEOUT_S:
                raise AssertionError(f"[tools] past {TOOLS_TIMEOUT_S} s: "
                                     f"{sorted(set(procs) - set(seconds))}")
            for name, (proc, _) in procs.items():
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.time() - t0
            time.sleep(0.2)
        for name, (proc, out) in procs.items():
            out.seek(0)
            text = out.read()
            if proc.returncode != 0:
                raise AssertionError(f"[tools] {name} exited "
                                     f"{proc.returncode}:\n{text[-4000:]}")
            results[name] = [json.loads(line) for line in text.splitlines()
                             if line.startswith("{")]
    finally:
        for proc, out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    for name, lines in results.items():
        _check_tool(name, lines, card)
        for r in lines:
            short = {k: v for k, v in r.items()
                     if k not in ("device", "argmax", "max")}
            log(f"[tools] {name}: {json.dumps(short)}")
    lat8 = next(r for r in results["latency"] if r["batch"] == 8)
    if argmax != lat8["argmax"]:
        raise AssertionError(f"[tools] latency argmax at batch 8 "
                             f"{lat8['argmax']} != the trainer's {argmax}")
    _free()
    total = time.time() - t0
    log(f"[tools] latency argmax at batch 8 {argmax} equals the trainer's "
        f"forward ({argmax_s:.1f} s); tools done at "
        f"{ {k: round(v, 1) for k, v in seconds.items()} } s; phase "
        f"{total:.1f} s")
    return {"lines": results, "seconds": seconds, "argmax_s": argmax_s,
            "phase_s": total, "argmax_batch8": argmax}


# phase_graphs: K steps a CUDA graph replay against single eager steps
GRAPH_K = 4
GRAPH_BATCHES = 12  # chunk 1 runs eagerly (the warm-up), 2 and 3 replay
GRAPH_ACCUM = (2, 3)  # gradient_accumulation_steps k, steps_per_dispatch K
GRAPH_EVAL_BATCHES = 4
# eager against graphed from one saved state: relative L2 of all the
# parameters, and each logged loss / train metric relative to max(1, |v|)
GRAPH_TOL = 1e-6
GRAPH_RUNS = {"frozen": ([], {}),
              "unfrozen_fused": (["model.vision.args.freeze=False"],
                                 FUSED_ENV)}
# model.remat under graphs (frozen, dropout on): K = 3 over 6 batches, chunk
# 1 eager, 2 captured (then replayed); graphed against eager bit for bit
GRAPH_REMAT_K = 3
GRAPH_REMAT_BATCHES = 6
GRAPH_REMAT = ("full", "dots")


def _graph_state(t):
    """What a train step moves: parameters and buffers, the optimizer, the
    dropout and attention-seed generators."""
    import copy

    from sceneverse_tpu_torch.modules.utils import _streams

    return ({k: v.detach().clone() for k, v in t.model.state_dict().items()},
            copy.deepcopy(t.optimizer.state_dict()),
            [g.get_state() for g in _streams(t.model)])


def _graph_restore(t, state):
    from sceneverse_tpu_torch.modules.utils import _streams

    model, opt, gens = state
    t.model.load_state_dict(model)
    t.optimizer.load_state_dict(opt)
    for g, st in zip(_streams(t.model), gens):
        g.set_state(st)
    t._graphs = {}  # the optimizer's state tensors were replaced


def _rows_k(metrics, losses):
    out = {**losses, **metrics}
    k = len(next(iter(out.values())))
    return [{n: float(v[j]) for n, v in out.items()} for j in range(k)]


def _graph_compare(tag, want_rows, got_rows, want_p, got_p):
    num = sum(float((got_p[n].double() - w.double()).norm() ** 2)
              for n, w in want_p.items())
    den = sum(float(w.double().norm() ** 2) for w in want_p.values())
    rel = (num / den) ** 0.5
    worst = max(abs(g[n] - w[n]) / max(1.0, abs(w[n]))
                for w, g in zip(want_rows, got_rows) for n in w)
    log(f"[graphs {tag}] {len(got_rows)} steps: parameters rel L2 "
        f"{rel:.3e}, rows worst {worst:.3e} (tol {GRAPH_TOL:g})")
    if not (len(want_rows) == len(got_rows) and rel <= GRAPH_TOL
            and worst <= GRAPH_TOL and math.isfinite(rel)):
        raise AssertionError(f"graphs {tag}: eager and graphed runs differ "
                             f"(params {rel}, rows {worst})")
    return {"param_rel_l2": rel, "rows_worst": worst}


def _graph_params(t):
    return {n: p.detach().clone() for n, p in t.model.named_parameters()}


def graph_equivalence(name, extra, env, accum=None):
    """From one saved state, GRAPH_BATCHES eager micro-steps against the same
    batches through ``train_forward_backward_k`` (chunk 1 eager, then
    replays), with the train metrics in the step; then two replays on one
    chunk must draw other masks; the step's CUDA-event ms eager and graphed
    and the peak memory at K = 1 and K; one H2D copy per chunk."""
    import torch

    from sceneverse_tpu_torch.ops import _build

    k_acc, K = accum or (1, GRAPH_K)
    over = extra + [f"data.synthetic_size={32 * GRAPH_BATCHES + 8}",
                    f"solver.steps_per_dispatch={K}",
                    f"solver.gradient_accumulation_steps={k_acc}"]
    tag = name + (f" k={k_acc} K={K}" if accum else f" K={K}")
    with gates(env):
        t = _trainer(f"graphs_{name}{'_accum' if accum else ''}", over)
        hosts = [b for _, b in zip(range(GRAPH_BATCHES),
                                   t.data_loaders["train"])]
        fused = t._fusable_metrics(t._train_evaluator())
        if fused is None:
            raise AssertionError(f"graphs {tag}: train metrics do not fuse")
        state = _graph_state(t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def eager_run():
            rows = []
            for h in hosts:
                m, l = t.train_forward_backward(t.device_batch(h), fused)
                rows.append({n: float(v) for n, v in {**l, **m}.items()})
            return rows

        eager = eager_run()
        torch.cuda.synchronize()
        peak1 = torch.cuda.max_memory_allocated() / 2 ** 30
        want_p = _graph_params(t)
        spread = None
        if name == "frozen" and not accum:
            # the eager run against itself: what the comparison resolves
            _graph_restore(t, state)
            spread = _graph_compare(tag + " eager twice", eager, eager_run(),
                                    want_p, _graph_params(t))
        _graph_restore(t, state)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        graphed = []
        for c in range(0, GRAPH_BATCHES, K):
            graphed += _rows_k(*t.train_forward_backward_k(hosts[c:c + K],
                                                           fused))
        torch.cuda.synchronize()
        peak_k = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = dict(_build.LAUNCHES)
        n_graphs = sum(g is not None for g in t._graphs.values())
        if n_graphs != (2 if accum else 1):
            raise AssertionError(f"graphs {tag}: {n_graphs} graphs captured")
        res = _graph_compare(tag, eager, graphed, want_p, _graph_params(t))
        res.update(peak_gib_k1=peak1, peak_gib_k=peak_k, launches=launches,
                   graphs=n_graphs, eager_twice=spread)
        if accum:
            if t.optimizer.step_count != GRAPH_BATCHES // k_acc:
                raise AssertionError(f"graphs {tag}: "
                                     f"{t.optimizer.step_count} updates")
            del t
            _free()
            return res
        # two replays on the same chunk: the masks advance
        a = _rows_k(*t.train_forward_backward_k(hosts[:K], fused))
        b = _rows_k(*t.train_forward_backward_k(hosts[:K], fused))
        if a[0]["total_loss"] == b[0]["total_loss"]:
            raise AssertionError(f"graphs {tag}: two replays drew one mask")
        # the step's CUDA-event time, eager (K single steps) and graphed,
        # with the default (atomic) algorithms: a new graph, warmed and
        # captured outside the deterministic mode
        torch.use_deterministic_algorithms(False)
        try:
            # all GRAPH_BATCHES batches a timed call, so that a batch's
            # host work overlaps the card's work on the one before, as in
            # the trainer's loop
            chunks = [hosts[c:c + K] for c in range(0, GRAPH_BATCHES, K)]
            t._graphs = {}
            for _ in range(2):
                t.train_forward_backward_k(hosts[:K], fused)
            res["step_ms_eager"] = cuda_ms(lambda: [
                t.train_forward_backward(t.device_batch(h), fused)
                for h in hosts], reps=2) / GRAPH_BATCHES
            res["step_ms_graphed"] = cuda_ms(lambda: [
                t.train_forward_backward_k(c, fused) for c in chunks],
                reps=2) / GRAPH_BATCHES
            if name == "frozen":  # eval groups of K batches
                fn = t._fusable_metrics(t._val_evaluator())
                for _ in range(2):
                    t.eval_metrics_k(hosts[:K], fn)
                res["eval_ms_eager"] = cuda_ms(lambda: [
                    fn({**b, **t.forward(b)}, include_count=True)
                    for b in map(t.device_batch, hosts)],
                    reps=2) / GRAPH_BATCHES
                res["eval_ms_graphed"] = cuda_ms(lambda: [
                    t.eval_metrics_k(c, fn) for c in chunks],
                    reps=2) / GRAPH_BATCHES
        finally:
            torch.use_deterministic_algorithms(True, warn_only=True)
        # packed transfer: the chunk's arrays in one host-to-device copy
        # (every copy_ from the host to the card counted; the profiler is
        # not used here: a replay under its CUPTI trace crashed the process)
        copies = []
        real_copy = torch.Tensor.copy_

        def counted(dst, src, *a, **kw):
            if dst.is_cuda and not src.is_cuda:
                copies.append(dst.numel() * dst.element_size())
            return real_copy(dst, src, *a, **kw)

        torch.Tensor.copy_ = counted
        try:
            t.train_forward_backward_k(hosts[:K], fused)
        finally:
            torch.Tensor.copy_ = real_copy
        st = next(iter(t._staging.values()))
        res["h2d_copies"] = len(copies)
        res["h2d_mb"] = sum(copies) / 1e6
        res["h2d_ms"] = cuda_ms(lambda: st.dev.copy_(st.host[0],
                                                     non_blocking=True))
        torch.cuda.synchronize()  # the same copy on the host's clock
        t0 = time.perf_counter()
        for _ in range(5):
            st.dev.copy_(st.host[0], non_blocking=True)
        torch.cuda.synchronize()
        res["h2d_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        if len(copies) != 1:
            raise AssertionError(f"graphs {tag}: {len(copies)} H2D copies "
                                 "in a chunk (packed transfer sends one)")
        evals = (f"; eval batch {res['eval_ms_eager']:.3f} ms eager, "
                 f"{res['eval_ms_graphed']:.3f} graphed"
                 if "eval_ms_eager" in res else "")
        log(f"[graphs {tag}] step {res['step_ms_eager']:.3f} ms eager, "
            f"{res['step_ms_graphed']:.3f} ms graphed (CUDA events){evals}; peak "
            f"{peak1:.2f} GiB at K=1, {peak_k:.2f} GiB at K={K}; one H2D "
            f"copy of {res['h2d_mb']:.1f} MB a chunk, {res['h2d_ms']:.3f} "
            f"ms ({res['h2d_host_ms']:.3f} on the host's clock); launches "
            f"in the graphed run {launches}")
        if name == "frozen":
            res["eval"] = graph_eval(t)
    del t
    _free()
    return res


def graph_remat(policy, peak_none):
    """``model.remat=true`` under ``policy`` at K = GRAPH_REMAT_K: from one
    saved state, GRAPH_REMAT_BATCHES eager micro-steps against the same
    batches through ``train_forward_backward_k`` (chunk 1 eager, 2
    captured, then replays), bit for bit (parameters, every logged loss and
    metric); the recompute's ``mha_fwd`` launches as ``remat_extra_fwd``
    counts them a step, eager and graphed; two replays on one chunk draw
    other masks; the peak of the graphed run (under "full" below
    ``peak_none``, the no-remat graphed run's); the remat tape's bytes a
    step; each step's CUDA-event ms eager and graphed."""
    import torch

    from sceneverse_tpu_torch.modules import utils as mutils
    from sceneverse_tpu_torch.ops import _build

    K, n = GRAPH_REMAT_K, GRAPH_REMAT_BATCHES
    tag = f"remat {policy} K={K}"
    t = _trainer(f"graphs_remat_{policy}", [
        "model.remat=true", f"model.remat_policy={policy}",
        f"data.synthetic_size={32 * n + 8}",
        f"solver.steps_per_dispatch={K}"])
    hosts = [b for _, b in zip(range(n), t.data_loaders["train"])]
    fused = t._fusable_metrics(t._train_evaluator())
    per_step = {"mha_fwd": DATA_PER_FORWARD["mha_fwd"]
                + remat_extra_fwd(t.cfg), "mha_bwd": DATA_PER_STEP["mha_bwd"]}
    state = _graph_state(t)
    # the tape of one eager step: the masks (bool) and seeds it keeps
    tapes = []
    init = mutils._Tape.__init__

    def taped_init(self):
        init(self)
        tapes.append(self)

    mutils._Tape.__init__ = taped_init
    try:
        t.train_forward_backward(t.device_batch(hosts[0]), fused)
    finally:
        mutils._Tape.__init__ = init
    tape_mb = sum(v.numel() * v.element_size() for tp in tapes
                  for v in tp.draws) / 2 ** 20
    del tapes
    _graph_restore(t, state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    eager = []
    for h in hosts:
        m, l = t.train_forward_backward(t.device_batch(h), fused)
        eager.append({k: float(v) for k, v in {**l, **m}.items()})
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated() / 2 ** 30
    launches_eager = {k: _build.LAUNCHES.get(k, 0) for k in per_step}
    want_p = _graph_params(t)
    _graph_restore(t, state)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    graphed = []
    for c in range(0, n, K):
        graphed += _rows_k(*t.train_forward_backward_k(hosts[c:c + K], fused))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(_build.LAUNCHES)
    got_p = _graph_params(t)
    n_graphs = sum(g is not None for g in t._graphs.values())
    rel = max(float((got_p[k] - w).abs().max()) for k, w in want_p.items())
    worst = max(abs(g[k] - w[k]) for w, g in zip(eager, graphed) for k in w)
    want_l = {k: v * n for k, v in per_step.items()}
    log(f"[graphs {tag}] {n} steps: parameters max |graphed - eager| "
        f"{rel!r}, rows worst {worst!r} (bit for bit); graphs {n_graphs}; "
        f"launches eager {launches_eager}, graphed {launches} (expected "
        f"{want_l}: {per_step['mha_fwd']} mha_fwd a step, "
        f"{remat_extra_fwd(t.cfg)} of them the recompute's); peak eager "
        f"{peak_eager:.3f} GiB, graphed {peak:.3f} GiB (no remat graphed "
        f"{peak_none:.3f}); tape {tape_mb:.1f} MiB a step")
    if not (rel == 0.0 and worst == 0.0 and len(graphed) == n
            and n_graphs == 1):
        raise AssertionError(f"graphs {tag}: eager and graphed differ "
                             f"(params {rel}, rows {worst}, {n_graphs} "
                             "graphs)")
    if launches_eager != want_l or {k: launches.get(k, 0)
                                    for k in per_step} != want_l:
        raise AssertionError(f"graphs {tag}: launches {launches_eager} / "
                             f"{launches}, expected {want_l}")
    if policy == "full" and not peak < peak_none:
        raise AssertionError(f"graphs {tag}: graphed peak {peak} GiB not "
                             f"below no remat's {peak_none}")
    a = _rows_k(*t.train_forward_backward_k(hosts[:K], fused))
    b = _rows_k(*t.train_forward_backward_k(hosts[:K], fused))
    if a[0]["total_loss"] == b[0]["total_loss"]:
        raise AssertionError(f"graphs {tag}: two replays drew one mask")
    res = {"param_max_abs": rel, "rows_worst": worst, "peak_gib": peak,
           "peak_gib_eager": peak_eager, "tape_mib": tape_mb,
           "launches": launches, "graphs": n_graphs}
    torch.use_deterministic_algorithms(False)
    try:
        t._graphs = {}
        for _ in range(2):
            t.train_forward_backward_k(hosts[:K], fused)
        chunks = [hosts[c:c + K] for c in range(0, n, K)]
        res["step_ms_eager"] = cuda_ms(lambda: [
            t.train_forward_backward(t.device_batch(h), fused)
            for h in hosts], reps=2) / n
        res["step_ms_graphed"] = cuda_ms(lambda: [
            t.train_forward_backward_k(c, fused) for c in chunks],
            reps=2) / n
    finally:
        torch.use_deterministic_algorithms(True, warn_only=True)
    log(f"[graphs {tag}] step {res['step_ms_eager']:.3f} ms eager, "
        f"{res['step_ms_graphed']:.3f} ms graphed (CUDA events)")
    del t
    _free()
    return res


def _head(batch, n):
    """The first ``n`` items of a host batch."""
    B = len(batch["obj_fts"])

    def cut(v):
        if hasattr(v, "shape"):
            return v[:n] if v.ndim and v.shape[0] == B else v
        if isinstance(v, (list, tuple)) and len(v) == B:
            return v[:n]
        return v

    return {k: cut(v) for k, v in batch.items()}


def graph_eval(t):
    """GRAPH_EVAL_BATCHES val batches and an 8-item tail batch through the
    fused eval (eval_steps_per_dispatch = 2: groups of 2, the tail its
    own), twice (the first pass runs each group's first occurrence eagerly
    and captures the second; the second pass replays every group, the tail
    included), against the eager loop: ``record()`` equal."""
    import torch

    ev = t._val_evaluator()
    t.eval_steps_per_dispatch = 2
    full = [b for _, b in zip(range(GRAPH_EVAL_BATCHES),
                              t.data_loaders["val"])]
    real = t.data_loaders["val"]
    # a tuple: one loader (a list would be a list of loaders)
    t.data_loaders["val"] = tuple(full + [_head(full[0], 8)])
    try:
        ev.JIT_METRICS = False  # the instance takes the eager loop
        t0 = time.time()
        _, eager = t._eval_loop("val", "val")
        t_eager = time.time() - t0
        del ev.JIT_METRICS
        t._graphs = {k: g for k, g in t._graphs.items() if k[0] != "eval"}
        fused = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            fused.append((t._eval_loop("val", "val")[1], time.time() - t0))
    finally:
        t.data_loaders["val"] = real
    graphs = {dict((n, s) for n, s, _ in k[1])["obj_fts"][0]: g is not None
              for k, g in t._graphs.items() if k[0] == "eval"}
    log(f"[graphs eval] {GRAPH_EVAL_BATCHES} val batches + an 8-item tail: "
        f"eager {t_eager:.3f} s, fused {fused[0][1]:.3f} s (eager first "
        f"groups, captures), {fused[1][1]:.3f} s (replays) (host clock); "
        f"graph captured by batch size {graphs}; record equal: "
        f"{[f == eager for f, _ in fused]}")
    if any(f != eager for f, _ in fused) or graphs != {32: True, 8: True}:
        raise AssertionError(f"graphs eval: fused {fused} != eager {eager} "
                             f"or graphs {graphs}")
    return {"eager_s": t_eager, "fused_s": [x for _, x in fused],
            "graphs": graphs}


def phase_graphs():
    """The JAX trainer's dispatch paths as CUDA graphs: frozen and
    unfrozen_fused at full width (f32, dropout on), accumulation across
    chunks, the fused eval with a tail batch, the packed transfer. Under
    ``torch.use_deterministic_algorithms`` (warn only): the embedding and
    gather backwards sum with atomics otherwise, and two eager runs from
    one state then part by about 1e-6 a step (``phase_trainer``)."""
    import torch

    t0 = time.time()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = {name: graph_equivalence(name, extra, env)
               for name, (extra, env) in GRAPH_RUNS.items()}
        out["accum"] = graph_equivalence("frozen", [], {}, accum=GRAPH_ACCUM)
        for policy in GRAPH_REMAT:
            out[f"remat_{policy}"] = graph_remat(
                policy, out["frozen"]["peak_gib_k"])
    finally:
        torch.use_deterministic_algorithms(False)
    out["seconds"] = time.time() - t0
    log(f"[graphs] phase {out['seconds']:.1f} s")
    return out


def phase_trainer():
    """The trainer: remat, accumulation, the 32-step run with a resume at
    step 16, and the profile / NaN / eval.save switches."""
    out = {}
    for name, sub in (("remat", trainer_remat), ("accum", trainer_accum),
                      ("run", trainer_run), ("switches", trainer_switches)):
        out[name] = sub()
        _free()
    return out


def main():
    sys.path.insert(0, REPO)
    card = phase_env()
    import torch

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    t_main = time.perf_counter()
    timed("build", phase_build)
    preprocess = timed("preprocess", phase_preprocess, card)
    tools = timed("tools", phase_tools, card)
    table = Table()
    for name, fn in (("sa", phase_sa), ("sample_group", phase_sample_group),
                     ("mha", phase_mha), ("sa_train", phase_sa_train),
                     ("flash", phase_flash)):
        timed(name, fn, table)
    slices = timed("slices", lambda: {
        name: phase_slice(name, extra, env)
        for name, (extra, _, env) in PATHS.items()})
    entry = timed("entry", phase_entry, slices["frozen_exact"])
    trainer = timed("trainer", phase_trainer)
    graphs = timed("graphs", phase_graphs)
    data = timed("data", phase_data, table)
    finetune = timed("finetune", phase_finetune, table,
                     data["run"]["exp_dir"])
    objcls = timed("objcls", phase_objcls, table)
    variants = timed("variants", phase_variants)
    ddp = timed("ddp", phase_ddp)
    mp = timed("mp", phase_mp, card)
    # what device_ms and kernel_sum_ms trace again: this late in the
    # process every other profiler window is empty
    graphs["profiler_windows"] = profiler_windows()
    seconds["total"] = time.perf_counter() - t_main
    log(f"[time] s a phase: {json.dumps(seconds)}")
    paths = {p: s["launches"] for p, s in slices.items()}
    paths["trainer"] = trainer["run"]["launches"]
    for name in GRAPH_RUNS:
        paths[f"graphs_{name}"] = graphs[name]["launches"]
    for policy in GRAPH_REMAT:
        paths[f"graphs_remat_{policy}"] = graphs[f"remat_{policy}"]["launches"]
    paths["profile_k2"] = trainer["switches"]["profile_k2"]["launches"]
    paths["data"] = data["run"]["launches"]
    paths["data_materialized"] = data["materialized"]["launches"]
    for name, run in finetune["runs"].items():
        paths[f"finetune_{name}"] = run["launches"]
    for name, run in objcls["runs"].items():
        paths[name] = run["launches"]
    paths["objcls_test"] = objcls["entry"]["launches"]
    paths["perscene_eval"] = objcls["perscene"]["eval_launches"]
    paths["perscene_train"] = objcls["perscene"]["train_launches"]
    for name, run in variants["runs"].items():
        paths[name] = run["launches"]
    paths["variant_pointnet"] = variants["pointnet_launches"]
    for name, run in ddp["runs"].items():  # every rank of both worlds
        paths[f"ddp_{name}"] = dict(sum(
            (collections.Counter(n) for n in run["launches"].values()),
            collections.Counter()))
    for name, world in mp["worlds"].items():  # every rank of each world
        paths[f"mp_{name}"] = dict(sum(
            (collections.Counter(r["launches"])
             for r in world["ranks"]["frozen"]), collections.Counter()))
    kernels = []
    for name, (src, rep) in SOURCES.items():
        row = table.rows[name]
        # headline: the heaviest call shape of the main path, f32 where the
        # kernel has an f32 form (no GPS caller passes flash attention a
        # bias, the SA rows' "+all-in" balls hold every point, and the data
        # phase's standard-normal objects are its yardstick: none is a
        # main-path input)
        shapes = [r for r in row["shapes"]
                  if not any(t in r["shape"] for t in
                             ("+ab", "+all-in", "standard-normal"))]
        head = max([r for r in shapes if r["dtype"] == "f32"] or shapes,
                   key=lambda r: r["ms"])
        by_path = {p: n.get(name, 0) for p, n in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            **({"device_ms": head["device_ms"]} if "device_ms" in head
               else {})})
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"kernels": kernels, "per_shape": table.rows,
                   "slices": slices, "entry": entry, "trainer": trainer,
                   "graphs": graphs,
                   "data": data, "finetune": finetune, "objcls": objcls,
                   "variants": variants, "ddp": ddp, "mp": mp,
                   "preprocess": preprocess, "tools": tools, "card": card,
                   "seconds": seconds},
                  f,
                  indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-child"]:
        ddp_child(json.loads(sys.argv[2]))
    else:
        main()
