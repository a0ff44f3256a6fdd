"""Decompose big-graph decode frame time into per-component device costs.

Runs the headline bench's decoder program plus isolated jitted programs
for each frame-step component at the REAL shapes/tables, so the numbers
are directly comparable, then sums the parts and prints the covered
fraction of the measured per-frame budget. Also times the three latgen
pipeline stages (device decode, record fetch, native extraction) so the
lattice-path bottleneck is visible. Run on an otherwise-idle machine.

Every timing loop ends in jax.block_until_ready, so it times the device
work, not the enqueue.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.decoder.csr_beam import BIG


def bench(name, f, *a, n=30):
    jax.block_until_ready(f(*a))       # compile
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(*a)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) * 1e3 / n
    print(f"{name:48s} {dt:8.3f} ms")
    return dt


def main():
    from kaldi_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from kaldi_tpu.decoder.biggraph import make_big_hclg, BigGraphConfig
    from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder, CsrBeamOpts,
                                            _dedup_topk, _segment_map)

    graph, _ = make_big_hclg(BigGraphConfig())
    K, CB = 7000, 8192
    dec = CsrBeamDecoder(graph, CsrBeamOpts(
        beam=13.0, max_active=K, acoustic_scale=0.1,
        expand_budget=CB, eps_budget=2048))
    tabs = dec.tabs
    B, T, P = 8, 998, 2048
    rng = np.random.RandomState(0)
    ll = jnp.asarray(rng.randn(B, T, P).astype(np.float32))
    nf = np.full(B, T, np.int32)

    # full best-path decode (the headline program), averaged
    fin = dec.decode_async(ll, nf)
    fin()               # warmup/compile + fetch
    n_full = 3
    t0 = time.perf_counter()
    for _ in range(n_full):
        dec.decode_async(ll, nf)()
    # finish() includes the one result fetch per decode
    dt = (time.perf_counter() - t0) / n_full
    print(f"{'FULL decode (best-path, mean of 3)':48s} {dt*1e3:8.1f} ms "
          f"({dt/T*1e3:.3f} ms/frame)")
    per_frame = dt / T * 1e3

    apr = int(tabs.b_apr)
    CBR = -(-CB // apr)
    AH = int(tabs.hub_rows.shape[0])
    H = len(tabs.hub_bounds) - 1
    tok_state = jnp.asarray(rng.randint(0, graph.num_states, (B, K),
                                        dtype=np.int32))
    tok_score = jnp.asarray(np.sort(rng.rand(B, K).astype(np.float32)))
    ll_t = jnp.asarray(rng.randn(B, P).astype(np.float32))
    rj = jnp.asarray(rng.randint(0, max(int(tabs.brow.shape[0]), 1),
                                 (B, CBR), dtype=np.int32))
    pdfs = jnp.asarray(rng.randint(0, P, (B, 2 * K + apr * CBR),
                                   dtype=np.int32))

    t_s = bench("srow gather [B,K] rows of 16",
                jax.jit(lambda s: tabs.srow[s]), tok_state)
    t_b = bench("brow gather [B,CBR] rows of 16",
                jax.jit(lambda i: tabs.brow[i]), rj)
    take = jax.jit(lambda t, p: jnp.take_along_axis(t, p, axis=1))
    t_ll = bench(f"take_ll [B,2K+{apr}CBR]", take, ll_t, pdfs)
    # tier-B base-score lookup over the [B, K] frontier-score table
    tjb = jnp.asarray(rng.randint(0, K, (B, CBR), dtype=np.int32))
    t_bs = bench("tier-B base_sc [B,CBR] of [B,K]", take, tok_score, tjb)

    # segment map at real shapes
    deg = jnp.asarray(rng.randint(0, 6, (B, K), dtype=np.int32))
    off = jnp.cumsum(deg, axis=1) - deg
    base = jnp.asarray(rng.randint(0, 1 << 20, (B, K), dtype=np.int32))
    t_seg = bench("segment_map (scatter+scans)",
                  jax.jit(lambda o, d, b: _segment_map(o, d, CBR, K, B,
                                                       base=b)),
                  off, deg, base)

    # hub pieces
    t_hm = t_he = t_hk = t_hr = 0.0
    if H:
        hs = tabs.hub_states
        hs_dev = jnp.asarray(hs.astype(np.int32))

        def hub_match(ts, tc):
            match = (ts[:, :, None] == hs_dev[None, None, :]) & \
                (tc[:, :, None] < BIG * 0.5)
            msc = jnp.where(match, tc[:, :, None], BIG)
            return jnp.min(msc, axis=1), jnp.argmin(msc, axis=1)

        t_hm = bench(f"hub match/min [B,K,{H}]", jax.jit(hub_match),
                     tok_state, tok_score)
        if tabs.hub_onehot is not None:
            G = tabs.hub_onehot.shape[1]
            am_g = jnp.asarray(rng.randn(B, G).astype(np.float32))
            t_he = bench(f"hub one-hot einsum [{AH},{G}]x[B,{G}]",
                         jax.jit(lambda oh, a: jnp.einsum(
                             "ag,bg->ba", oh, a,
                             precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)),
                         tabs.hub_onehot, am_g)
        sc_flat = jnp.asarray(rng.randn(B, AH).astype(np.float32))
        # mirror the decoder's trace-time selection: variadic sort when
        # K <= 2048, lax.top_k above (csr_beam.py hub_emit)
        if K <= 2048:
            def hub_sel(s):
                jarange = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
                ssc, idx_s = jax.lax.sort((s, jarange), dimension=1,
                                          num_keys=2)
                return ssc[:, :K], idx_s[:, :K]
            t_hk = bench(f"hub select (sort path) {K} of {AH}",
                         jax.jit(hub_sel), sc_flat)
        else:
            t_hk = bench(f"hub select (top_k path) {K} of {AH}",
                         jax.jit(lambda s: jax.lax.top_k(-s, K)), sc_flat)
        idx = jnp.asarray(rng.randint(0, AH, (B, K), dtype=np.int32))
        t_hr = bench("hub_rows gather [B,K] rows of 8",
                     jax.jit(lambda i: tabs.hub_rows[i]), idx)

    # candidate merge at the real shape (csr_beam merge()): ONE f32
    # concat + min + beam-mask over scores plus THREE plain int32
    # concats riding along. Each array is distinct so XLA cannot CSE
    # the four concats into one.
    NC = 2 * K + apr * CBR + (K if H else 0)
    widths = (K, K) + (CBR,) * apr + ((K,) if H else ())
    sc_parts = [jnp.asarray(rng.randn(B, n).astype(np.float32))
                for n in widths]
    int_parts = [[jnp.asarray(rng.randint(0, 1 << 20, (B, n),
                                          dtype=np.int32))
                  for n in widths] for _ in range(3)]

    def merge_like(args):
        sps = args[0]
        csc = jnp.concatenate(sps, axis=1)
        best = jnp.min(csc, axis=1, keepdims=True)
        csc = jnp.where(csc > best + 13.0, BIG, csc)
        return [csc] + [jnp.concatenate(ip, axis=1) for ip in args[1:]]

    t_mg = bench(f"merge concat+beam-mask [B,{NC}] (1 f32 + 3 int32)",
                 jax.jit(merge_like), [sc_parts] + int_parts)

    # dedup at real candidate count
    cst = jnp.asarray(rng.randint(0, graph.num_states, (B, NC),
                                  dtype=np.int32))
    csc = jnp.asarray(rng.randn(B, NC).astype(np.float32))
    crec = jnp.asarray(rng.randint(0, 1 << 20, (B, NC), dtype=np.int32))
    cil = jnp.asarray(rng.randint(0, 1 << 14, (B, NC), dtype=np.int32))
    t_d = bench(f"dedup 2x variadic sort [B,{NC}]",
                jax.jit(lambda a, b, c, d: _dedup_topk(a, b, c, d, K)),
                cst, csc, crec, cil)

    parts_sum = (t_s + t_b + t_ll + t_bs + t_seg + t_hm + t_he + t_hk
                 + t_hr + t_mg + t_d)
    print(f"\nper-frame budget: {per_frame:.3f} ms; measured parts sum "
          f"{parts_sum:.3f} ms = {parts_sum / per_frame * 100:.0f}% of it "
          f"(remainder: unpack/where arithmetic + scan overhead)")

    # ---------------- latgen pipeline stages -----------------------
    lat_dec = CsrBeamDecoder(graph, CsrBeamOpts(
        beam=13.0, max_active=1024, acoustic_scale=0.1,
        expand_budget=8192, eps_budget=2048))
    ll_np = np.asarray(ll)
    fin = lat_dec.decode_raw_async(ll_np, nf)
    fin()   # warmup/compile
    # stage 1+2: device decode + full record fetch ([B,T,R,K]
    # states+scores device->host)
    t0 = time.perf_counter()
    raw = lat_dec.decode_raw_async(ll_np, nf)()
    dt_rawfetch = time.perf_counter() - t0
    rec_bytes = sum(a.nbytes for a in
                    (raw["states"], raw["scores"], raw["init_states"],
                     raw["init_scores"], raw["final_states"],
                     raw["final_scores"]))
    print(f"\n{'latgen decode+fetch (K=1024 records)':48s} "
          f"{dt_rawfetch*1e3:8.1f} ms  ({rec_bytes/1e6:.1f} MB records, "
          f"{rec_bytes/1e6/dt_rawfetch:.1f} MB/s effective)")
    # stage 1 alone ~= the FULL best-path decode time above (same scan,
    # record writes added); stage 2 = the decode+fetch line minus it.
    # stage 3: native extraction per utterance (threaded); nothing else
    # is in flight during this window.
    from kaldi_tpu.lat.generate import raw_lattice_from_decode
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as ex:
        lats = list(ex.map(
            lambda b: raw_lattice_from_decode(lat_dec, raw, nf, b, 8.0),
            range(B)))
    dt_ext = time.perf_counter() - t0
    n_arcs = sum(l.num_arcs for l in lats if l is not None)
    print(f"{'latgen native extraction (8 threads)':48s} "
          f"{dt_ext*1e3:8.1f} ms  ({n_arcs} arcs)")
    audio = B * T * 0.01
    print(f"latgen stage ceilings: decode+fetch {audio/dt_rawfetch:.1f} "
          f"audio-s/s, extraction {audio/dt_ext:.1f} audio-s/s")


if __name__ == "__main__":
    main()
