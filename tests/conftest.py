"""Test session setup: lock jax to the default 1-device CPU backend early so
any later import that touches XLA_FLAGS (e.g. repro.launch.dryrun helpers)
cannot change the device count, and keep hypothesis CI-friendly.

Hypothesis is optional: when it is absent the profile registration is
skipped and test modules fall back to the deterministic shim in
``_hypothesis_compat`` — the suite must never abort at collection because
of a missing dev dependency."""
import jax

jax.devices()  # initialize backend now (1 CPU device)

try:
    from hypothesis import HealthCheck, settings
except ImportError:
    pass
else:
    settings.register_profile(
        "ci",
        max_examples=20,
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
    )
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an sm_90 CUDA card; skipped on machines without one")
