import os
import sys

# Tests run on the single real CPU device (the dry-run sets its own flags
# in a separate process).  Keep test-time compilation light.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Hermetic staging decisions: an operator-local `make calibrate` artifact
# (or a REPRO_CALIBRATION exported in the developer's shell) must not
# leak measured costs into test-time stage ordering / park decisions —
# tests pin the static fallback, so this is an unconditional override,
# not a setdefault.  Tests that exercise calibration loading pass
# explicit paths, which bypass the env var entirely (see
# repro.core.costmodel.default_cost_model).
os.environ["REPRO_CALIBRATION"] = "off"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest

# Optional test-only dependencies (tests/requirements-test.txt).  The suite
# must collect and run green without them: modules that use hypothesis
# either pytest.importorskip it (test_query_fuzz.py) or fall back to a
# deterministic seeded sweep of the same property (test_aggregates.py,
# test_query_properties.py).
try:
    import hypothesis  # noqa: F401
    HAS_HYPOTHESIS = True
except ModuleNotFoundError:
    HAS_HYPOTHESIS = False

if HAS_HYPOTHESIS:
    # Env-gated example budgets: the full profile is the default
    # (``make test``); REPRO_HYPOTHESIS_PROFILE=ci (``make test-fast``)
    # trims the property sweeps for quick iteration.  Tests must NOT pin
    # ``max_examples`` in their own @settings or the profile cannot
    # override it — use ``@settings(deadline=None)`` only.
    from hypothesis import settings as _hyp_settings
    _hyp_settings.register_profile("full", max_examples=100, deadline=None)
    _hyp_settings.register_profile("ci", max_examples=10, deadline=None)
    _hyp_settings.load_profile(
        os.environ.get("REPRO_HYPOTHESIS_PROFILE", "full"))

from repro.models.config import BlockKind, ModelConfig


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels have no CPU "
        "mode); skipped at run time when torch finds no CUDA device.")
    config.addinivalue_line(
        "markers",
        "slow: extended repeated-trial statistical sweeps (hundreds of "
        "seeded trials at full stream sizes).  Skipped by default — the "
        "default profile runs the seeded cheap variants of the same "
        "properties (mirroring the hypothesis full/ci split above); "
        "enable with REPRO_SLOW=1 (``make test-slow``).")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    """On any failure, surface the generating seed(s) of a seeded sweep
    in the report — every randomized battery in this suite derives the
    whole case from integer seed parameters, so the printed line is a
    complete repro recipe (pytest "tests/<file>::<test>[<params>]")."""
    outcome = yield
    rep = outcome.get_result()
    if rep.when != "call" or not rep.failed:
        return
    callspec = getattr(item, "callspec", None)
    if callspec is None:
        return
    seeds = {k: v for k, v in callspec.params.items()
             if "seed" in k.lower()}
    if seeds:
        rep.sections.append(
            ("seeded sweep", "failing seed(s): "
             + ", ".join(f"{k}={v!r}" for k, v in sorted(seeds.items()))
             + f"\nreproduce: pytest '{item.nodeid}'"))


def pytest_collection_modifyitems(config, items):
    if os.environ.get("REPRO_SLOW", "") not in ("", "0"):
        return
    skip = pytest.mark.skip(reason="slow statistical sweep; set "
                            "REPRO_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=128, dtype="float32", max_seq_len=256,
            attn_impl="xla_naive", scan_layers=True)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def temporal_replay_oracle():
    """The naive per-frame replay semantics temporal automata must match
    bit-for-bit (shared across property/regression modules so every
    temporal test states equivalence against the same specification)."""
    from repro.core.temporal import replay_reference
    return replay_reference


@pytest.fixture(scope="session")
def tiny_dense():
    return ModelConfig(name="dense", **BASE)


@pytest.fixture(scope="session")
def tiny_moe():
    return ModelConfig(name="moe", block=BlockKind.MOE, n_experts=4,
                       experts_per_token=2, capacity_factor=64.0, **BASE)


@pytest.fixture(scope="session")
def tiny_rwkv():
    return ModelConfig(name="rwkv", block=BlockKind.RWKV6, rwkv_head_dim=16,
                       **BASE)


@pytest.fixture(scope="session")
def tiny_hybrid():
    return ModelConfig(name="hybrid", block=BlockKind.HYBRID, ssm_state=8,
                       **BASE)
