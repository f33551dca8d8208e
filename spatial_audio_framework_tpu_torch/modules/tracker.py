"""3-D multi-target tracker (counterpart of
``spatial_audio_framework_tpu/modules/tracker.py`` and of ``saf_tracker``):
a Rao-Blackwellised Monte-Carlo data-association (RBMCDA) particle filter
(Särkkä et al.), with 6-D constant-velocity Kalman filters per target.

Host-side NumPy, an own copy of the JAX package's module (which imports
no JAX either; the port imports nothing of that package): the tracker runs
at visual frame rates on tiny state (the reference is likewise scalar CPU
code, saf_tracker_internal.c), so a device port would only add latency.
Matches the reference's event machinery: clutter / existing-target /
new-target hypotheses, gamma-distributed death, optional forced kills,
importance resampling to the dominant particle (tracker3d_step,
saf_tracker.c:166-280), with the same ``default_rng(seed)`` draws in the
same order as the JAX package's module.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
from scipy.linalg import expm
from scipy.special import gamma as sps_gamma
from scipy.special import gammainc

TRACKER3D_MAX_NUM_PARTICLES = 100


@dataclass
class Tracker3DConfig:
    """saf_tracker.h:59-107 ``tracker3d_config``."""
    n_particles: int = 20
    dt: float = 1.0 / 20.0
    max_n_active_targets: int = 8
    noise_likelihood: float = 0.2
    measure_noise_sd: float = 0.5
    noise_spec_den: float = 1.0
    allow_multi_death: bool = True
    init_birth: float = 0.5
    alpha_death: float = 20.0
    beta_death: float = 1.0
    force_kill_targets: bool = True
    force_kill_distance: float = 0.2
    are_unit_vectors: bool = True
    M0: np.ndarray = field(default_factory=lambda: np.zeros(6))
    P0: np.ndarray = field(default_factory=lambda: np.eye(6))
    cd: float = 1.0 / (4.0 * np.pi)
    w_avg_coeff: float = 0.5


def lti_disc(F: np.ndarray, Qc: np.ndarray, dt: float):
    """Discretise an LTI system (saf_tracker_internal.c ``lti_disc``):
    A = expm(F dt); Q by matrix fraction decomposition."""
    n = F.shape[0]
    A = expm(F * dt)
    Phi = np.zeros((2 * n, 2 * n))
    Phi[:n, :n] = F
    Phi[:n, n:] = Qc
    Phi[n:, n:] = -F.T
    AB = expm(Phi * dt) @ np.vstack([np.zeros((n, n)), np.eye(n)])
    Q = AB[:n] @ np.linalg.inv(AB[n:])
    return A, Q


def kf_predict6(M, P, A, Q):
    """saf_tracker_internal.h:299 ``kf_predict6``."""
    return A @ M, A @ P @ A.T + Q


def kf_update6(M, P, y, H, R):
    """saf_tracker_internal.h:353 ``kf_update6`` → (M', P', likelihood)."""
    IM = H @ M
    S = H @ P @ H.T + R
    K = P @ H.T @ np.linalg.inv(S)
    M2 = M + K @ (y - IM)
    P2 = P - K @ H @ P
    d = y - IM
    det = np.linalg.det(2.0 * np.pi * S)
    lh = np.exp(-0.5 * d @ np.linalg.solve(S, d)) / np.sqrt(max(det, 1e-30))
    return M2, P2, float(lh)


def gamma_cdf(x, alpha, beta, mu=0.0):
    """saf_tracker_internal.c:740-753 ``gamma_cdf``.

    Mirrors the reference EXACTLY, including its extra division by Γ(x'):
    the C evaluates P(alpha, x') / Γ(x'), where P is the already-regularised
    lower incomplete gamma (cephes igam).  A true gamma CDF would be just
    P(alpha, x') — the reference's expression is not monotonic in x — but
    the death-probability dynamics of the tracker depend on the C's actual
    values, so behavioural parity requires reproducing them (pinned by the
    trk_gamma_cdf golden in tests/test_c_goldens.py)."""
    xs = (x - mu) / beta
    if xs <= 0.0:
        return 0.0
    return float(gammainc(alpha, xs) / sps_gamma(xs))


@dataclass
class _Particle:
    W: float
    W_prev: float
    W0: float
    dt: float
    M: List[np.ndarray] = field(default_factory=list)
    P: List[np.ndarray] = field(default_factory=list)
    target_ids: List[int] = field(default_factory=list)
    t_count: List[int] = field(default_factory=list)

    def copy(self) -> "_Particle":
        return _Particle(self.W, self.W_prev, self.W0, self.dt,
                         [m.copy() for m in self.M],
                         [p.copy() for p in self.P],
                         list(self.target_ids), list(self.t_count))


class Tracker3D:
    """saf_tracker.h:123-161 ``tracker3d_create/reset/step``."""

    def __init__(self, cfg: Tracker3DConfig, seed: int = 0):
        cfg.n_particles = int(np.clip(cfg.n_particles, 1,
                                      TRACKER3D_MAX_NUM_PARTICLES))
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        sd2 = cfg.measure_noise_sd ** 2
        self.R = np.eye(3) * sd2
        F = np.zeros((6, 6))
        F[:3, 3:] = np.eye(3)
        Qc = np.zeros((6, 6))
        Qc[3:, 3:] = np.eye(3) * cfg.noise_spec_den
        self.A, self.Q = lti_disc(F, Qc, cfg.dt)
        self.H = np.zeros((3, 6))
        self.H[:, :3] = np.eye(3)
        self.reset()

    def reset(self):
        w0 = 1.0 / self.cfg.n_particles
        self.particles = [_Particle(w0, w0, w0, self.cfg.dt)
                          for _ in range(self.cfg.n_particles)]
        self.increment_time = 0

    # -- core steps (saf_tracker_internal.c:202,357) -------------------------
    def _predict(self, t_inc: int = 1):
        cfg = self.cfg
        for S in self.particles:
            dead = []
            for j in range(len(S.M)):
                if len(dead) == 0 or cfg.allow_multi_death:
                    dt0 = S.t_count[j] * S.dt
                    dt1 = dt0 + S.dt * t_inc
                    if dt0 == 0:
                        p_death = gamma_cdf(dt1, cfg.alpha_death, cfg.beta_death)
                    else:
                        g1 = gamma_cdf(dt1, cfg.alpha_death, cfg.beta_death)
                        g0 = gamma_cdf(dt0, cfg.alpha_death, cfg.beta_death)
                        p_death = 1.0 - (1.0 - g1) / max(1.0 - g0, 1e-12)
                    if cfg.force_kill_targets:
                        for k in range(len(S.M)):
                            if k != j:
                                dd = np.linalg.norm(S.M[j][:3] - S.M[k][:3])
                                if (dd < cfg.force_kill_distance
                                        and S.t_count[j] <= S.t_count[k]):
                                    p_death = 1.0
                    if self.rng.uniform() < p_death:
                        dead.append(j)
                if j not in dead:
                    S.M[j], S.P[j] = kf_predict6(S.M[j], S.P[j], self.A, self.Q)
            for j in sorted(dead if cfg.allow_multi_death else dead[:1],
                            reverse=True):
                del S.M[j], S.P[j], S.t_count[j], S.target_ids[j]

    def _update(self, y: np.ndarray, t_inc: int):
        cfg = self.cfg
        for pi, S in enumerate(self.particles):
            n_t = len(S.M)
            tp0 = (1.0 - cfg.noise_likelihood) / (n_t + 2.23e-10)
            events, evp, evl = [], [], []
            # clutter
            events.append(("clutter", None))
            evp.append((1.0 - cfg.init_birth) * cfg.noise_likelihood)
            evl.append(cfg.cd)
            # existing targets
            for j in range(n_t):
                M2, P2, lh = kf_update6(S.M[j], S.P[j], y, self.H, self.R)
                if cfg.are_unit_vectors:
                    M2 = M2.copy()
                    M2[:3] /= max(np.linalg.norm(M2[:3]), 1e-12)
                events.append(("target", (j, M2, P2)))
                evp.append((1.0 - cfg.init_birth) * tp0)
                evl.append(lh)
            # new target
            if n_t < cfg.max_n_active_targets:
                M2, P2, lh = kf_update6(cfg.M0, cfg.P0, y, self.H, self.R)
                if cfg.are_unit_vectors:
                    M2 = M2.copy()
                    M2[:3] /= max(np.linalg.norm(M2[:3]), 1e-12)
                taken = set(S.target_ids)
                j_new = next(s for s in range(cfg.max_n_active_targets + 1)
                             if s not in taken)
                events.append(("new", (j_new, M2, P2)))
                evp.append(cfg.init_birth)
                evl.append(lh)
            evp = np.asarray(evp) / max(np.sum(evp), 1e-30)
            imp = evp * np.asarray(evl)
            imp = imp / max(imp.sum(), 1e-30)
            ev = int(self.rng.choice(len(imp), p=imp))
            kind, data = events[ev]
            if kind == "target":
                j, M2, P2 = data
                S.M[j], S.P[j] = M2, P2
                S.t_count = [t + t_inc for t in S.t_count]
            elif kind == "new":
                j_new, M2, P2 = data
                S.M.append(M2)
                S.P.append(P2)
                S.target_ids.append(j_new)
                S.t_count.append(0)
            S.W *= evl[ev] * evp[ev] / max(imp[ev], 1e-30)
        wsum = sum(S.W for S in self.particles)
        for S in self.particles:
            S.W /= max(wsum, 1e-30)

    def _eff_particles(self) -> float:
        return 1.0 / max(sum(S.W ** 2 for S in self.particles), 1e-30)

    def step(self, new_obs_xyz: Optional[np.ndarray]):
        """One tracker step (saf_tracker.c:166 ``tracker3d_step``).
        new_obs_xyz: (nObs, 3) or None → (positions (nT,3), variances (nT,3),
        ids (nT,))."""
        cfg = self.cfg
        self.increment_time += 1
        if new_obs_xyz is not None and len(new_obs_xyz) > 0:
            for y in np.atleast_2d(new_obs_xyz):
                for _ in range(self.increment_time):
                    self._predict(1)
                self._update(np.asarray(y, float), self.increment_time)
                self.increment_time = 0
                if self._eff_particles() < cfg.n_particles / 4.0:
                    max_idx = int(np.argmax([S.W for S in self.particles]))
                    best = self.particles[max_idx]
                    self.particles = [best.copy() for _ in self.particles]
                    for S in self.particles:
                        S.W = S.W0
                if cfg.w_avg_coeff > 1e-4:
                    for S in self.particles:
                        S.W = (S.W * (1.0 - cfg.w_avg_coeff)
                               + S.W_prev * cfg.w_avg_coeff)
                        S.W_prev = S.W
        best = self.particles[int(np.argmax([S.W for S in self.particles]))]
        if not best.M:
            return (np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0, int))
        pos = np.stack([m[:3] for m in best.M])
        var = np.stack([np.diag(p)[:3] for p in best.P])
        ids = np.asarray(best.target_ids, int)
        return pos, var, ids
