"""Differentially private sketching (--dp sketch) and its accountant.

Port of ``commefficient_tpu/privacy/``: ``mechanism`` holds the
in-round primitives (the per-client clip, the calibrated Gaussian noise
on the aggregated table, the seeded noise streams that every draw of
the port's DP takes), ``accountant`` the Rényi-DP composition of the
Gaussian mechanism and its ε(δ) conversion, pure host math.
"""

from commefficient_tpu_torch.privacy.accountant import (  # noqa: F401
    PrivacyAccountant, build_accountant, eps_from_rdp,
    rdp_subsampled_gaussian, sample_rate_of, steps_to_budget)
from commefficient_tpu_torch.privacy.mechanism import (  # noqa: F401
    NOISE_TAG, SERVER_NOISE_TAG, WORKER_NOISE_TAG, add_table_noise, dp_clip,
    gaussian_noise, noise_generator, stream_seed, table_noise_std,
    table_sensitivity)
