"""The SGMM2 acoustic model.

(ref: sgmm2/am-sgmm2.h — global parameters: shared full-covariance UBM
 (Σ_i, unadapted means), phonetic subspace M_i [D, S] (:425), speaker
 subspace N_i [D, T] (:427), log-weight projections w_i [S] (:429);
 per-state substate vectors v_jm [S] and substate weights c_jm.

 Likelihood of frame x in substate (j, m), Gaussian i:
   μ_jmi = M_i v_jm (+ N_i s for speaker vector s)
   w_jmi = exp(w_i·v_jm) / Σ_i' exp(w_i'·v_jm)
   p(x|j) = Σ_m c_jm Σ_i w_jmi N(x; μ_jmi, Σ_i)

 All per-frame work is batched einsums over the gselect'd Gaussians: the
 reference's per-frame caches (:142,165,199) become precomputed tensors
 (H_i, normalizers) contracted as GEMMs.

 The sgmm2-specific speaker-dependent weight projection u_i (:431) is not
 yet implemented (spk weights are substate-independent), noted for a later
 round.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_tpu.gmm.full_gmm import FullGmm

LOG_2PI = float(np.log(2.0 * np.pi))


@dataclasses.dataclass
class Sgmm2SpeakerState:
    """Per-speaker vector (ref: sgmm2/am-sgmm2.h Sgmm2PerSpkDerivedVars)."""
    v: np.ndarray   # [T]


class AmSgmm2:
    def __init__(self, ubm: FullGmm, num_states: int, phn_dim: int,
                 spk_dim: int = 0, seed: int = 0):
        """Initialize from a trained full-covariance UBM
        (ref: sgmm2bin/sgmm2-init.cc / AmSgmm2::InitializeFromFullGmm):
        M_i's first column = UBM mean μ_i, v_j0 = e_1, so the initial model
        equals the UBM tied across states."""
        I, D = ubm.means.shape
        S = phn_dim
        rng = np.random.RandomState(seed)
        self.Sigma_inv = ubm.inv_covars()            # [I, D, D]
        self.M = np.zeros((I, D, S))
        self.M[:, :, 0] = ubm.means
        if S > 1:
            # remaining columns: small random directions (the reference
            # uses LDA-ish init; random suffices to break symmetry)
            self.M[:, :, 1:] = rng.randn(I, D, S - 1) * 0.1
        self.w = np.zeros((I, S))
        self.w[:, 0] = np.log(np.maximum(ubm.weights, 1e-10))
        self.N = rng.randn(I, D, spk_dim) * 0.1 if spk_dim > 0 else None
        self.v = [[np.eye(S)[0].copy()] for _ in range(num_states)]
        self.c = [np.ones(1) for _ in range(num_states)]
        self._update_derived()

    # --- sizes ---

    @property
    def num_gauss(self):
        return self.M.shape[0]

    @property
    def dim(self):
        return self.M.shape[1]

    @property
    def phn_dim(self):
        return self.M.shape[2]

    @property
    def spk_dim(self):
        return 0 if self.N is None else self.N.shape[2]

    @property
    def num_states(self):
        return len(self.v)

    def _update_derived(self):
        """Precompute per-Gaussian terms (ref: AmSgmm2::ComputeDerivedVars):
        gconst_i = -0.5 (D log2π − log|Σ_i⁻¹|); H_i = M_iᵀ Σ_i⁻¹ M_i."""
        I, D, S = self.M.shape
        sign, logdet = np.linalg.slogdet(self.Sigma_inv)
        self.gconst = -0.5 * (D * LOG_2PI - logdet)
        self.SinvM = np.einsum("ide,ies->ids", self.Sigma_inv, self.M)
        self.H = np.einsum("ids,idt->ist", self.M, self.SinvM)

    # --- likelihoods ---

    def gselect(self, feats: np.ndarray, num_gselect: int = 10):
        """Top Gaussians per frame by UBM-style full-covar loglike
        (ref: Sgmm2GselectConfig am-sgmm2.h:118). -> [T, G] indices."""
        T = feats.shape[0]
        # loglike under (mean = M_i v_avg ~ UBM mean = M[:, :, 0]·1)
        mu = self.M[:, :, 0]
        d = feats[:, None, :] - mu[None, :, :]            # [T, I, D]
        q = np.einsum("tid,ide,tie->ti", d, self.Sigma_inv, d)
        # UBM-style selection includes the component log-weight (w[:, 0]
        # holds log UBM weights at init; ref: FullGmm::LogLikelihoods)
        ll = self.gconst[None, :] - 0.5 * q + self.w[None, :, 0]
        k = min(num_gselect, self.num_gauss)
        return np.argsort(-ll, axis=1)[:, :k]

    def _substate_quantities(self, j: int, spk: Sgmm2SpeakerState | None):
        """-> (v_jm [M,S], log w_jmi [M,I], means μ_jmi [M,I,D])."""
        V = np.stack(self.v[j])                            # [M, S]
        logw = V @ self.w.T                                # [M, I]
        logw = logw - _logsumexp(logw, axis=1, keepdims=True)
        sets = getattr(self, "norm_set_ids", None)
        if sets is not None:
            # renormalize within each Gaussian subset (typically gender)
            # so each subset's weights sum to one per substate
            # (ref: sgmm/am-sgmm.cc:822 ComputeNormalizersNormalized)
            for s in np.unique(sets):
                idx = np.flatnonzero(sets == s)
                logw[:, idx] -= _logsumexp(logw[:, idx], axis=1,
                                           keepdims=True)
        mu = np.einsum("ids,ms->mid", self.M, V)           # [M, I, D]
        if spk is not None and self.N is not None:
            mu = mu + np.einsum("idt,t->id", self.N, spk.v)[None]
        return V, logw, mu

    def log_likelihood(self, j: int, x: np.ndarray, gsel=None,
                       spk: Sgmm2SpeakerState | None = None):
        """log p(x|j) for one frame, optionally restricted to gselect."""
        V, logw, mu = self._substate_quantities(j, spk)
        d = x[None, None, :] - mu                          # [M, I, D]
        q = np.einsum("mid,ide,mie->mi", d, self.Sigma_inv, d)
        ll = (np.log(np.maximum(self.c[j], 1e-20))[:, None]
              + logw + self.gconst[None, :] - 0.5 * q)     # [M, I]
        if gsel is not None:
            mask = np.full(ll.shape, -np.inf)
            mask[:, gsel] = 0.0
            ll = ll + mask
        return _logsumexp(ll.reshape(-1))

    def component_posteriors(self, j: int, x: np.ndarray, gsel=None,
                             spk=None):
        """-> (post [M, I] normalized, loglike)."""
        V, logw, mu = self._substate_quantities(j, spk)
        d = x[None, None, :] - mu
        q = np.einsum("mid,ide,mie->mi", d, self.Sigma_inv, d)
        ll = (np.log(np.maximum(self.c[j], 1e-20))[:, None]
              + logw + self.gconst[None, :] - 0.5 * q)
        if gsel is not None:
            keep = np.zeros(self.num_gauss, bool)
            keep[gsel] = True
            ll[:, ~keep] = -np.inf
        tot = _logsumexp(ll.reshape(-1))
        post = np.exp(ll - tot)
        return post, tot

    def loglikes_matrix(self, feats: np.ndarray, num_gselect: int = 10,
                        spk=None) -> np.ndarray:
        """[T, num_states] pseudo-loglikes for the decoder.

        Batched per STATE (per-state quantities are frame-independent):
        one [T, M, I] quadratic-form einsum per state instead of T
        rebuilds of the substate tensors."""
        T = feats.shape[0]
        out = np.zeros((T, self.num_states))
        gsel = self.gselect(feats, num_gselect)
        keep = np.zeros((T, self.num_gauss), bool)
        np.put_along_axis(keep, gsel, True, axis=1)
        x = np.asarray(feats, np.float64)
        for j in range(self.num_states):
            V, logw, mu = self._substate_quantities(j, spk)
            d = x[:, None, None, :] - mu[None]             # [T, M, I, D]
            q = np.einsum("tmid,ide,tmie->tmi", d, self.Sigma_inv, d)
            ll = (np.log(np.maximum(self.c[j], 1e-20))[None, :, None]
                  + logw[None] + self.gconst[None, None, :] - 0.5 * q)
            ll = np.where(keep[:, None, :], ll, -np.inf)
            out[:, j] = _logsumexp(ll.reshape(T, -1), axis=1)
        return out

    # --- dimension surgery (ref: sgmmbin/sgmm-mixup.cc →
    # AmSgmm::IncreasePhoneSpaceDim / IncreaseSpkSpaceDim) ---

    def increase_phn_dim(self, new_S: int, seed: int = 0):
        """Grow the phonetic subspace to new_S columns: existing columns
        are kept, new M_i columns are small random directions, substate
        vectors are zero-padded (so likelihoods are unchanged)."""
        I, D, S = self.M.shape
        if new_S <= S:
            return
        if new_S > D + 1:
            raise ValueError(f"phn dim {new_S} > feature dim + 1 = {D + 1}")
        rng = np.random.RandomState(seed)
        M2 = np.zeros((I, D, new_S))
        M2[:, :, :S] = self.M
        M2[:, :, S:] = rng.randn(I, D, new_S - S) * 0.1
        self.M = M2
        w2 = np.zeros((I, new_S))
        w2[:, :S] = self.w
        self.w = w2
        self.v = [[np.concatenate([vm, np.zeros(new_S - S)])
                   for vm in vj] for vj in self.v]
        self._update_derived()

    def increase_spk_dim(self, new_T: int, seed: int = 0):
        """Grow (or create) the speaker subspace to new_T columns."""
        I, D, _S = self.M.shape
        if new_T > D:
            raise ValueError(f"spk dim {new_T} > feature dim {D}")
        rng = np.random.RandomState(seed)
        T_old = self.spk_dim
        if new_T <= T_old:
            return
        N2 = np.zeros((I, D, new_T))
        if self.N is not None:
            N2[:, :, :T_old] = self.N
        N2[:, :, T_old:] = rng.randn(I, D, new_T - T_old) * 0.1
        self.N = N2

    def remove_speaker_space(self):
        self.N = None

    # --- substate splitting (ref: AmSgmm2::SplitSubstates) ---

    def split_substates(self, target_total: int, perturb: float = 0.01,
                        state_occs=None, seed: int = 0):
        rng = np.random.RandomState(seed)
        total = sum(len(c) for c in self.c)
        if state_occs is None:
            state_occs = np.ones(self.num_states)
        while total < target_total:
            # split the substate with the largest (occ * c_jm)
            best = None
            for j in range(self.num_states):
                for m in range(len(self.c[j])):
                    score = state_occs[j] * self.c[j][m]
                    if best is None or score > best[0]:
                        best = (score, j, m)
            _s, j, m = best
            v = self.v[j][m]
            noise = rng.randn(self.phn_dim) * perturb
            self.v[j][m] = v + noise
            self.v[j].append(v - noise)
            cc = self.c[j][m] / 2
            self.c[j][m] = cc
            self.c[j] = np.append(self.c[j], cc)
            total += 1


def _logsumexp(a, axis=None, keepdims=False):
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    out = m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True))
    if not keepdims and axis is not None:
        out = np.squeeze(out, axis=axis)
    elif not keepdims:
        out = out.reshape(())
    return out
