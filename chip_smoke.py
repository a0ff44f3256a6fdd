"""Smoke run of the main path on the GPU, checked against plain references.

    python chip_smoke.py               # one GPU: phases 1-6 below
    python chip_smoke.py --devices 4   # four GPUs: only the multi-device paths

One card, at the widths bench.py uses:
  1. device: refuse anything but a GPU backend; print the card, its power
     limit, the JAX version and which native libraries loaded;
  2. 16 kHz fbank (40 bins) + per-utterance CMVN + the relu TDNN
     (1024 wide, 2048 pdfs) on B=8 x 10 s of decoder/simulate.py audio:
     f32 on the GPU against f32 on the CPU backend, and the bf16 path
     against f32;
  3. bf16 TDNN training on the synthetic corpus: finite, falling loss,
     and a timed window of steps;
  4. best-path CSR beam search (beam 13, max_active 7000) over the
     1.05M-state / 11.1M-arc HCLG on the trained model's scores, with a
     B=2 x 200-frame slice decoded on the GPU and on the CPU backend:
     identical words and overflow counts, equal costs;
  5. pipelined lattice generation from lossless records with native
     extraction: every lattice non-empty, its best path equal to phase
     4's hypothesis;
  6. streaming (FusedOnlineDecoder, 160 ms chunks) equal to offline decode.

Four cards: dp training on a ('data'=4) mesh against one card at the same
global batch, decode_sharded, decode_frontier_sharded and the lockstep
FusedStreamingServer over the mesh, each against one card.

Any failed check raises, so the process exits non-zero. The last line on
stdout is one JSON object: {"ok": true, "device": {"platform", "kind",
"count"}}. Weights and data are made from fixed seeds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# the CPU backend is the reference in phases 2 and 4; keep it available
# when the caller pinned the platform list to the GPU alone
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

SR = 16000.0
LATTICE_BEAM = 8.0

# Tolerances, each with its reason:
#  - FEAT_ATOL: fbank + CMVN in f32 on both backends; cuFFT and the CPU
#    FFT sum in different orders, and log() differs in the last ulps.
#    CMVN'd features are O(1), so 1e-3 is ~1000x the expected spread.
#  - F32_LOGPOST_ATOL: the TDNN forward with precision="highest" on both
#    backends (true f32 GEMMs, no TF32): only summation order differs.
#  - BF16_*: bf16 GEMM operands keep 8 mantissa bits (~0.4% per element)
#    against f32; what must survive is the frame decision, and the
#    log-posteriors must stay close on average.
#  - COST_ATOL: decode costs are sums of the same f32 values in the
#    same order on both backends; any difference is a real divergence,
#    so the bound only absorbs printing-level noise.
FEAT_ATOL = 1e-3
F32_LOGPOST_ATOL = 1e-3
BF16_ARGMAX_AGREE = 0.97
BF16_LOGPOST_MEAN_ATOL = 0.05
COST_ATOL = 1e-3


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def say(*a):
    print(*a, flush=True)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Workload widths. FULL is the bench operating point; TINY keeps the
    same code paths small enough for a CPU rehearsal."""

    graph: tuple = ()              # BigGraphConfig overrides
    num_pdfs: int = 2048
    hidden: int = 1024
    frames: int = 1000             # 10 s per utterance
    n_train: int = 16
    n_test: int = 8
    train_steps: int = 400
    timed_steps: int = 20
    max_active: int = 7000
    expand_budget: int = 16384
    eps_budget: int = 2048
    slice_b: int = 2
    slice_t: int = 200
    stream_t_max: int = 1024
    dp_steps: int = 200
    server_secs: float = 3.0


FULL = Sizes()
TINY = Sizes(graph=(("vocab", 300), ("avg_bigram_succ", 20),
                    ("num_pdfs", 64), ("seed", 1)),
             num_pdfs=64, hidden=128, frames=200, n_train=4, n_test=4,
             train_steps=150, timed_steps=3, max_active=512,
             expand_budget=4096, eps_budget=2048, slice_b=2, slice_t=100,
             stream_t_max=256,
             dp_steps=6, server_secs=1.0)


# ----------------------------------------------------------------- phase 1

def nvidia_smi_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_phase(n_devices: int):
    import jax
    backend = jax.default_backend()
    check(backend == "gpu",
          f"no GPU: JAX default backend is {backend!r}; this smoke run "
          f"does not fall back to the CPU")
    devs = jax.devices()
    check(len(devs) >= n_devices,
          f"need {n_devices} GPUs, JAX sees {len(devs)}")
    say(f"[1] device: {devs[0].device_kind} x{len(devs)}, "
        f"jax {jax.__version__}")
    smi = nvidia_smi_lines()
    for ln in smi:
        say(ln)
    native = native_report()
    say("[1] native libraries: " + ", ".join(
        f"{k}={'loaded' if v else 'MISSING'}" for k, v in native.items()))
    check(all(native.values()), f"native library missing: {native}")
    return devs, "; ".join(smi)


def native_report() -> dict:
    from kaldi_tpu.io import native as ark
    from kaldi_tpu.fst import native_ops
    from kaldi_tpu.lat import native_gen
    return {"io/native": ark.available(),
            "fst/native_ops": native_ops.available(),
            "lat/native_gen": native_gen.available()}


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


# ---------------------------------------------------------------- workload

@dataclasses.dataclass
class Workload:
    S: Sizes
    graph: object
    waves: np.ndarray         # [N, samples] f32
    words: list               # reference word ids per utterance
    fb_opts: object
    feats: object             # [N, Tf, 40] fbank + CMVN (device)
    tgt: np.ndarray           # [N, Tf] pdf targets
    model: object


def cmvn_fbank(fb_opts):
    import jax.numpy as jnp
    from kaldi_tpu.ops import fbank

    def feats_of(waves):
        # per-utterance CMVN, as apply-cmvn in the reference pipeline
        f = fbank(waves, fb_opts)
        mu = jnp.mean(f, axis=1, keepdims=True)
        sd = jnp.std(f, axis=1, keepdims=True)
        return (f - mu) / (sd + 1e-5)

    return feats_of


def build_workload(S: Sizes, seed: int = 0) -> Workload:
    import jax
    from kaldi_tpu.ops import FbankOpts, FrameOpts, MelOpts
    from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu.decoder.biggraph import make_big_hclg, BigGraphConfig
    from kaldi_tpu.decoder.simulate import make_corpus, fbank_targets

    t0 = time.perf_counter()
    graph, _ = make_big_hclg(BigGraphConfig(**dict(S.graph)))
    rng = np.random.default_rng(seed)
    waves, segs, words = make_corpus(graph, S.n_train + S.n_test, S.frames,
                                     rng, noise=0.25)
    fb_opts = FbankOpts(frame_opts=FrameOpts(samp_freq=SR, dither=0.0),
                        mel_opts=MelOpts(num_bins=40))
    feats = jax.jit(cmvn_fbank(fb_opts))(waves)
    Tf = int(feats.shape[1])
    tgt = np.stack([fbank_targets(segs[n], Tf) for n in range(len(segs))])
    model = Tdnn(TdnnConfig(feat_dim=40, num_pdfs=S.num_pdfs,
                            hidden_dim=S.hidden, pnorm_output_dim=256,
                            nonlinearity="relu"))
    say(f"[2] workload: graph {graph.num_states} states / "
        f"{graph.num_arcs} arcs, {len(waves)} utterances x "
        f"{S.frames / 100:.1f} s ({time.perf_counter() - t0:.1f} s host)")
    return Workload(S, graph, waves, words, fb_opts, feats, tgt, model)


# ----------------------------------------------------------------- phase 2

def forward_phase(W: Workload, cpu):
    """fbank+CMVN and the f32 forward on the default device against the
    CPU backend, then bf16 against f32 on the default device."""
    import jax
    import jax.numpy as jnp
    S = W.S
    model = W.model
    params = model.init(jax.random.PRNGKey(1))
    # init() zeroes the final affine; random final weights make the
    # comparison see real log-posteriors instead of a uniform row
    params["final"]["w"] = jax.random.normal(
        jax.random.PRNGKey(2), params["final"]["w"].shape) / np.sqrt(
            S.hidden)
    waves = W.waves[S.n_train:]
    feats_of = jax.jit(cmvn_fbank(W.fb_opts))
    fwd = jax.jit(lambda p, f: model.apply(p, f, pad_context=True))
    fwd16 = jax.jit(lambda p, f: model.apply(p, f, pad_context=True,
                                             compute_dtype=jnp.bfloat16))
    feats_dev = feats_of(waves)
    feats_cpu = feats_of(jax.device_put(waves, cpu))
    d_feat = float(np.max(np.abs(np.asarray(feats_dev)
                                 - np.asarray(feats_cpu))))
    with jax.default_matmul_precision("highest"):
        lp_dev = np.asarray(fwd(params, feats_dev))
        lp_cpu = np.asarray(fwd(jax.device_put(params, cpu),
                                jax.device_put(np.asarray(feats_dev), cpu)))
    lp16 = np.asarray(fwd16(params, feats_dev))
    d32 = float(np.max(np.abs(lp_dev - lp_cpu)))
    d16 = np.abs(lp16 - lp_dev)
    agree = float(np.mean(np.argmax(lp16, -1) == np.argmax(lp_dev, -1)))
    say(f"[2] features {tuple(feats_dev.shape)}: max |dev - cpu| "
        f"{d_feat:.2e} (tol {FEAT_ATOL})")
    say(f"[2] f32 log-posteriors {lp_dev.shape}: max |dev - cpu| "
        f"{d32:.2e} (tol {F32_LOGPOST_ATOL})")
    say(f"[2] bf16 vs f32: mean |diff| {float(d16.mean()):.3e} (tol "
        f"{BF16_LOGPOST_MEAN_ATOL}), max {float(d16.max()):.3e}, argmax "
        f"agreement {agree:.4f} (min {BF16_ARGMAX_AGREE})")
    check(np.isfinite(lp_dev).all() and np.isfinite(lp16).all(),
          "non-finite log-posteriors")
    check(d_feat <= FEAT_ATOL, f"features differ from CPU by {d_feat}")
    check(d32 <= F32_LOGPOST_ATOL, f"f32 forward differs from CPU by {d32}")
    check(float(d16.mean()) <= BF16_LOGPOST_MEAN_ATOL,
          f"bf16 forward mean diff {float(d16.mean())}")
    check(agree >= BF16_ARGMAX_AGREE, f"bf16 argmax agreement {agree}")


# ----------------------------------------------------------------- phase 3

def train_inputs(W: Workload):
    import jax.numpy as jnp
    lc, rc = W.model.config.left_context, W.model.config.right_context
    Tf = W.tgt.shape[1]
    feats = W.feats[:W.S.n_train]
    tgt = jnp.asarray(W.tgt[:W.S.n_train, lc: Tf - rc])
    return feats, tgt, jnp.ones(tgt.shape, jnp.float32)


def make_trainer(W: Workload, steps: int, mesh=None):
    import jax.numpy as jnp
    from kaldi_tpu.nnet.train import (NnetTrainOpts, make_optimizer,
                                      make_train_step)
    opts = NnetTrainOpts(initial_lr=0.1, final_lr=0.02, max_grad_norm=5.0)
    optimizer = make_optimizer(opts, steps)
    return optimizer, make_train_step(W.model, optimizer, mesh=mesh,
                                      compute_dtype=jnp.bfloat16)


def train(W: Workload, steps: int, mesh=None):
    """-> (params, per-step losses, last frame accuracy)."""
    import jax
    optimizer, step = make_trainer(W, steps, mesh)
    params = W.model.init(jax.random.PRNGKey(0))
    opt_state = optimizer.init(params)
    feats, tgt, w = train_inputs(W)
    losses, acc = [], None
    for _ in range(steps):
        params, opt_state, loss, acc = step(params, opt_state, feats, tgt, w)
        losses.append(loss)
    return params, np.asarray(jax.device_get(losses)), float(acc), \
        (step, opt_state)


def train_phase(W: Workload, card: str):
    import jax
    S = W.S
    t0 = time.perf_counter()
    params, losses, acc, (step, opt_state) = train(W, S.train_steps)
    dt_all = time.perf_counter() - t0
    n = max(1, min(10, len(losses) // 4))
    first, last = float(losses[:n].mean()), float(losses[-n:].mean())
    say(f"[3] train {S.train_steps} bf16 steps ({dt_all:.1f} s incl. "
        f"compile): loss {first:.3f} -> {last:.3f}, frame acc {acc:.3f}")
    check(np.isfinite(losses).all(), "non-finite training loss")
    check(last < first, f"training loss did not fall ({first} -> {last})")
    feats, tgt, w = train_inputs(W)
    frames_per_step = int(np.prod(tgt.shape))
    p, o = params, opt_state
    jax.block_until_ready(p)
    t0 = time.perf_counter()
    for _ in range(S.timed_steps):
        p, o, loss, _acc = step(p, o, feats, tgt, w)
    jax.block_until_ready((p, loss))
    dt = (time.perf_counter() - t0) / S.timed_steps
    say(f"[3] train step {dt * 1e3:.2f} ms, {frames_per_step / dt:.0f} "
        f"frames/s ({frames_per_step} frames/step) on {card}")
    return params, acc


# ----------------------------------------------------------------- phase 4

def decode_opts(S: Sizes, **kw):
    from kaldi_tpu.decoder.csr_beam import CsrBeamOpts
    return CsrBeamOpts(beam=13.0, max_active=S.max_active,
                       acoustic_scale=0.1, expand_budget=S.expand_budget,
                       eps_budget=S.eps_budget, **kw)


def am_scorer(W: Workload, params):
    """Trained-model scores as the bench computes them: fbank + CMVN +
    bf16 TDNN in one program."""
    import jax
    import jax.numpy as jnp
    feats_of = cmvn_fbank(W.fb_opts)
    return jax.jit(lambda waves: W.model.apply(
        params, feats_of(waves), pad_context=True,
        compute_dtype=jnp.bfloat16))


def same_hyps(a, b, what: str, cost_atol: float = COST_ATOL):
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} results")
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        check((x is None) == (y is None), f"{what}: utt {i} None mismatch")
        if x is None:
            continue
        check(list(x[0]) == list(y[0]),
              f"{what}: utt {i} words differ:\n {list(x[0])}\n {list(y[0])}")
        worst = max(worst, abs(float(x[2]) - float(y[2])))
    check(worst <= cost_atol, f"{what}: cost differs by {worst}")
    return worst


def decode_phase(W: Workload, params, cpu):
    import jax
    from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder
    from kaldi_tpu.utils.wer import compute_wer
    S = W.S
    opts = decode_opts(S)
    t0 = time.perf_counter()
    dec = CsrBeamDecoder(W.graph, opts)
    say(f"[4] decoder packed in {time.perf_counter() - t0:.1f} s "
        f"(hub arcs {dec.tabs.hub_rows.shape[0]}, tier-B rows "
        f"{dec.tabs.brow.shape[0]})")
    ll = am_scorer(W, params)(W.waves[S.n_train:])
    B, T = int(ll.shape[0]), int(ll.shape[1])
    nf = np.full(B, T, np.int32)
    res = dec.decode(ll, nf)               # compiles
    t0 = time.perf_counter()
    res = dec.decode(ll, nf)
    dt = time.perf_counter() - t0
    overflow = int(dec.last_overflow.sum())
    occ = float(dec.last_active_sum.sum()) / (B * T)
    hyps = {b: [str(x) for x in r[0]] if r else [] for b, r in
            enumerate(res)}
    refs = {b: [str(x) for x in W.words[S.n_train + b]] for b in range(B)}
    wer = compute_wer(refs, hyps).wer
    say(f"[4] decode B={B} x {T} frames: overflow {overflow} arcs, "
        f"occupancy mean {occ:.1f} / peak {int(dec.last_active_max.max())}"
        f" of {S.max_active}, corpus WER {wer:.2f}%, one warm decode "
        f"{dt:.3f} s")
    check(all(r is not None for r in res), "decode produced no hypothesis")

    # the same slice on the device and on the CPU backend
    sb, st = S.slice_b, min(S.slice_t, T)
    ll_np = np.asarray(ll)
    ll_s = np.ascontiguousarray(ll_np[:sb, :st])
    nf_s = np.full(sb, st, np.int32)
    res_dev = dec.decode(ll_s, nf_s)
    ovf_dev = np.asarray(dec.last_overflow).copy()
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        dec_cpu = CsrBeamDecoder(W.graph, opts)
        res_cpu = dec_cpu.decode(ll_s, nf_s)
    ovf_cpu = np.asarray(dec_cpu.last_overflow)
    dcost = same_hyps(res_dev, res_cpu, "device vs CPU decode")
    check(np.array_equal(ovf_dev, ovf_cpu),
          f"overflow differs: device {ovf_dev} vs CPU {ovf_cpu}")
    say(f"[4] slice B={sb} x {st}: device == CPU words and overflow "
        f"{ovf_dev.tolist()}, max cost diff {dcost:.2e} (CPU side "
        f"{time.perf_counter() - t0:.1f} s)")
    return dec, ll_np, nf, res


# ----------------------------------------------------------------- phase 5

def lattice_phase(W: Workload, ll_np, nf, res):
    from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder
    from kaldi_tpu.lat.functions import lattice_best_path
    from kaldi_tpu.lat.generate import decode_to_lattices_stream
    from kaldi_tpu.lat import native_gen
    S = W.S
    check(native_gen.available(), "native lattice extractor not loaded")
    # lossless records (the whole frontier, rec_beam = search beam):
    # the lattice then holds the decode's Viterbi chain, so its best
    # path must equal phase 4's; f16 relative scores and the flat
    # record buffer (sized so it cannot overflow) as the bench ships
    lat_dec = CsrBeamDecoder(W.graph, decode_opts(
        S, rec_f16=True, rec_flat=True, rec_flat_cap=S.max_active))
    t0 = time.perf_counter()
    outs = list(decode_to_lattices_stream(
        lat_dec, [(ll_np, nf)], lattice_beam=LATTICE_BEAM, num_threads=8))
    dt = time.perf_counter() - t0
    lats = outs[0]
    check(len(lats) == len(res), "one lattice per utterance")
    n_arcs = 0
    for b, lat in enumerate(lats):
        check(lat is not None and lat.num_arcs > 0, f"utt {b}: no lattice")
        n_arcs += lat.num_arcs
        bp = lattice_best_path(lat)
        words = [w for w in bp[0] if w != 0]
        check(words == list(res[b][0]),
              f"utt {b}: lattice best path differs from the decode:\n "
              f"{words}\n {list(res[b][0])}")
    say(f"[5] lattices: {len(lats)} non-empty, {n_arcs} arcs, best paths "
        f"== decode; truncated record slots "
        f"{int(lat_dec.last_rec_trunc.sum())}, flat fallbacks "
        f"{lat_dec.last_flat_fallbacks} ({dt:.1f} s incl. compile)")


# ----------------------------------------------------------------- phase 6

def streaming_am(W: Workload, params):
    """AmNnet for the streaming path, which computes raw fbank: fold a
    corpus-level CMVN into the first affine so the trained model sees
    normalised inputs."""
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.ops import fbank
    from kaldi_tpu.nnet.am_nnet import AmNnet
    raw = np.asarray(jax.jit(lambda w: fbank(w, W.fb_opts))(W.waves))
    mu = raw.reshape(-1, raw.shape[-1]).mean(0)
    sd = raw.reshape(-1, raw.shape[-1]).std(0) + 1e-5
    ctx = len(W.model.config.splice_indexes[0])
    l0 = dict(params["layers"][0])
    w = np.asarray(l0["w"])
    l0["w"] = jnp.asarray(w / np.tile(sd, ctx)[:, None])
    l0["b"] = jnp.asarray(np.asarray(l0["b"]) - np.tile(mu / sd, ctx) @ w)
    p = dict(params)
    p["layers"] = [l0] + list(params["layers"][1:])
    return AmNnet(W.model, p)


def offline_decode(am, dec, fb_opts, wave):
    import jax.numpy as jnp
    from kaldi_tpu.ops import fbank
    feats = np.asarray(fbank(jnp.asarray(wave), fb_opts))
    ll = am.loglikes_np(feats[None])
    return dec.decode(ll, np.array([feats.shape[0]], np.int32))[0]


def streaming_phase(W: Workload, params, dec):
    from kaldi_tpu.online.fused import FusedOnlineDecoder
    S = W.S
    am = streaming_am(W, params)
    chunk = 2560                                   # 160 ms at 16 kHz
    wave = W.waves[S.n_train]
    fused = FusedOnlineDecoder(am, dec, W.fb_opts, chunk_samples=chunk,
                               t_max=S.stream_t_max)
    t0 = time.perf_counter()
    for pos in range(0, len(wave), chunk):
        fused.accept_waveform(wave[pos: pos + chunk])
    fused.input_finished()
    got = fused.best_path()
    dt = time.perf_counter() - t0
    off = offline_decode(am, dec, W.fb_opts, wave)
    check(got is not None and off is not None, "no streamed hypothesis")
    check(list(got[1]) == list(off[1]), "streamed tids differ from offline")
    same_hyps([got], [off], "streamed vs offline", cost_atol=1e-2)
    say(f"[6] streaming {len(wave) / SR:.1f} s in {chunk}-sample chunks: "
        f"{len(got[0])} words == offline, cost {got[2]:.3f} vs "
        f"{off[2]:.3f} ({dt:.1f} s incl. compile)")


def run_single(S: Sizes, cpu, card: str):
    W = build_workload(S)
    forward_phase(W, cpu)
    params, _acc = train_phase(W, card)
    dec, ll_np, nf, res = decode_phase(W, params, cpu)
    lattice_phase(W, ll_np, nf, res)
    streaming_phase(W, params, dec)


# ----------------------------------------------------- four-device phase

# dp training against one card at the same global batch. Step 0 is the
# same forward on the same weights, and one update later only rounding
# differs: the mesh sums per-shard bf16 weight gradients where one card
# sums the whole batch in one GEMM. A wrong dp gradient (no all-reduce,
# a sum for a mean) is O(1) off by step 1. After that, bf16 SGD
# trajectories drift apart (10% apart at some step of 200 on four H100s
# with per-step comparison), so the end is held to where training lands.
DP_EARLY_STEPS = 5
DP_EARLY_RTOL = 1e-2
DP_FINAL_RTOL = 0.1
DP_FINAL_ACC_ATOL = 0.02


def run_multi(S: Sizes, devices):
    """The multi-device paths on `devices` (all of one mesh), each
    against a single-device run of the same work. Every part runs even
    if an earlier one failed; any failure raises at the end."""
    import traceback
    import jax
    from kaldi_tpu.parallel.mesh import make_mesh, decode_sharded
    from kaldi_tpu.parallel.frontier_decode import decode_frontier_sharded
    from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder
    from kaldi_tpu.online.serving import FusedStreamingServer
    D = len(devices)
    W = build_workload(S)
    mesh = make_mesh(data=D, devices=devices)
    failures = []

    def part(name, fn):
        try:
            fn()
        except Exception as e:     # record it, run the other parts
            traceback.print_exc()
            failures.append(f"{name}: {type(e).__name__}: {e}")

    trained = {}

    def dp_training():
        _p1, l1, a1, _ = train(W, S.dp_steps)
        pD, lD, aD, _ = train(W, S.dp_steps, mesh=mesh)
        trained["params"] = jax.device_get(pD)
        rel = np.abs(lD - l1) / np.maximum(np.abs(l1), 1e-6)
        n = DP_EARLY_STEPS
        end1, endD = float(l1[-10:].mean()), float(lD[-10:].mean())
        rel_end = abs(endD - end1) / max(abs(end1), 1e-6)
        say(f"[dp] {S.dp_steps} bf16 steps on {D} devices vs 1: first {n} "
            f"steps max rel diff {float(rel[:n].max()):.2e} (tol "
            f"{DP_EARLY_RTOL}); last-10 mean loss {end1:.4f} vs {endD:.4f}"
            f" (rel {rel_end:.3f}, tol {DP_FINAL_RTOL}); frame acc "
            f"{a1:.3f} vs {aD:.3f}; per-step max rel diff "
            f"{float(rel.max()):.2e} at step {int(rel.argmax())}")
        check(np.isfinite(lD).all(), "non-finite dp loss")
        check(float(rel[:n].max()) <= DP_EARLY_RTOL,
              "dp training differs from one card in its first steps")
        check(rel_end <= DP_FINAL_RTOL and abs(aD - a1) <= DP_FINAL_ACC_ATOL,
              "dp training lands elsewhere than one card")

    part("dp training", dp_training)
    params = trained.get("params") or jax.device_get(
        W.model.init(jax.random.PRNGKey(0)))
    dec = CsrBeamDecoder(W.graph, decode_opts(S))
    ll = np.asarray(am_scorer(W, params)(W.waves[S.n_train:]))
    B, T = ll.shape[:2]
    nf = np.full(B, T, np.int32)

    def utterance_sharded():
        single = dec.decode(ll, nf)
        ovf1 = np.asarray(dec.last_overflow).copy()
        shard = decode_sharded(dec, ll, nf, mesh)
        same_hyps(single, shard, "decode_sharded vs 1 device")
        check(np.array_equal(ovf1, dec.last_overflow),
              "decode_sharded overflow differs")
        say(f"[sharded] decode_sharded B={B} x {T} on {D} devices == 1 "
            f"device (overflow {ovf1.tolist()})")

    def frontier_sharded():
        fmesh = make_mesh(data=1, model=D, devices=devices)
        st = min(S.slice_t, T)
        ll_f = np.ascontiguousarray(ll[:1, :st])
        nf_f = np.array([st], np.int32)
        one = dec.decode(ll_f, nf_f)
        fs = decode_frontier_sharded(dec, ll_f, nf_f, fmesh, axis="model")
        same_hyps(one, fs, "decode_frontier_sharded vs 1 device")
        say(f"[sharded] decode_frontier_sharded 1 x {st} over {D} devices "
            f"== 1 device")

    def serving():
        am = streaming_am(W, params)
        n_samp = int(S.server_secs * SR)
        waves = [W.waves[S.n_train + i][:n_samp] for i in range(D)]
        t_max = int(S.server_secs * 100) + 64

        def serve(mesh_):
            srv = FusedStreamingServer(am, dec, W.fb_opts, n_streams=D,
                                       chunk_samples=2560, t_max=t_max,
                                       mesh=mesh_)
            slots = [srv.open() for _ in waves]
            for s, wv in zip(slots, waves):
                srv.feed(s, wv)
                srv.input_finished(s)
            for s in slots:
                srv.drain(s)
            return [srv.best_path(s) for s in slots]

        same_hyps(serve(None), serve(mesh),
                  "FusedStreamingServer mesh vs 1 device")
        say(f"[sharded] FusedStreamingServer {D} streams x "
            f"{S.server_secs} s over the mesh == 1 device")

    part("decode_sharded", utterance_sharded)
    part("decode_frontier_sharded", frontier_sharded)
    part("FusedStreamingServer", serving)
    check(not failures, "multi-device parts failed:\n " +
          "\n ".join(failures))


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 runs only the multi-device paths on 4 GPUs")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import kaldi_tpu
    except ImportError as e:
        raise SmokeFailure(f"kaldi_tpu is not importable next to "
                           f"chip_smoke.py: {e}") from e
    check(os.path.dirname(os.path.dirname(os.path.abspath(
        kaldi_tpu.__file__))) == here,
          f"kaldi_tpu imported from {kaldi_tpu.__file__}, not from the "
          f"checkout next to chip_smoke.py")
    from kaldi_tpu.utils.compile_cache import enable_compile_cache
    import jax
    say(f"[1] compile cache: {enable_compile_cache()}")
    devs, card = device_phase(args.devices)
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    if args.devices == 1:
        run_single(FULL, cpu, card)
    else:
        run_multi(FULL, devs[:args.devices])
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(result_line(devs[:args.devices]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
