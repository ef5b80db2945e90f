"""Nested sampling: evidence + mode weights with NO reference density.

`bp.Smc` (examples/smc_evidence.py) answers the separated-modes
question by annealing from a reference density — which the user must
choose, and choose WIDE enough (the reference-breadth rule). Nested sampling
(beyond-reference,
samplers/ns.py) answers the same question with one less knob: the
prior itself is the reference. Live points shrink from the full prior
cube through every basin simultaneously, so mode weights come out
right structurally, and the evidence arrives with its own error bar
(logZ ± √(H/K)) — no annealing schedule, no reference variance, no
acceptance target (the default kernel is exact slice sampling).

The contract is MultiNest/dynesty's: supply ``prior_transform(u)``
(inverse-CDF map from the unit cube) and ``log_like(θ)``. Here the
prior is uniform on [-10, 10]^d, so the analytic evidence of the
normalised unequal mixture is logZ = −d·log(20) exactly — the script
checks the estimate against it, the error bar against the miss, and
the 70/30 mode masses against the posterior weights.

Run: ``python examples/nested_sampling.py``.
"""

import math
import jax
import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp

D = 6
SIDE = 20.0                               # prior cube [-10, 10]^d
SEP = 6.0
WEIGHTS = np.array([0.7, 0.3])
MEANS = np.stack([np.full(D, -SEP / 2), np.full(D, SEP / 2)]).astype(
    np.float32)
NORM = -0.5 * D * math.log(2.0 * math.pi)


def log_like(x):
    comp = (NORM - 0.5 * jnp.sum((x[None, :] - jnp.asarray(MEANS)) ** 2, -1)
            + jnp.log(jnp.asarray(WEIGHTS, jnp.float32)))
    return jax.scipy.special.logsumexp(comp)


def prior_transform(u):
    return SIDE * u - 0.5 * SIDE


def main():
    sampler = bp.NestedSampler(log_like, prior_transform, D,
                               n_live=1024, n_batch=64, n_mcmc=12,
                               max_batches=600, seed=0)
    info = sampler.run()
    true_logz = -D * math.log(SIDE)       # normalised mixture over the cube

    print(f"batches: {info['n_batches']}   "
          f"likelihood evals: {info['n_like_evals']:,} "
          f"({info['evals_per_rep']:.1f}/slice-rep)")
    print(f"log Z = {info['log_evidence']:.3f} ± "
          f"{info['log_evidence_err']:.3f}   (analytic {true_logz:.3f})")
    assert info["terminated"]
    assert abs(info["log_evidence"] - true_logz) \
        < 3.5 * info["log_evidence_err"]

    # posterior mode masses from the weighted dead+live set
    w = np.exp(sampler.log_weights)
    w = np.where(np.isfinite(w), w, 0.0)
    w = w / w.sum()
    near_0 = np.sum((sampler.samples - MEANS[0]) ** 2, axis=1) \
        < (SEP * SEP * D) / 4.0
    frac = float(w[near_0].sum())
    print(f"mode-1 posterior mass: {frac:.3f}   (true {WEIGHTS[0]})")
    assert abs(frac - WEIGHTS[0]) < 0.06, frac

    # equal-weight posterior draws for downstream use
    draws = sampler.resample(2000)
    m1 = draws[np.sum((draws - MEANS[0]) ** 2, 1) < (SEP * SEP * D) / 4]
    print(f"mode-1 within-mode posterior sd: {m1.std(0).mean():.3f} "
          "(true 1.0)")
    assert abs(m1.std(0).mean() - 1.0) < 0.1
    print("OK")


if __name__ == "__main__":
    main()
