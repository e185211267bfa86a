import os

# CPU unless the caller names a platform (the card tests run with
# JAX_PLATFORMS=cuda,cpu); 8 virtual CPU devices for the sharding tests
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
import jax  # noqa: E402
import pytest  # noqa: E402

# f64 enabled because the parity oracles need double precision
jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="session")
def ref_decks():
    """Skip when the reference decks' data files are not there
    (CONP_REF_TESTS names their directory)."""
    from lammps_user_conp2_tpu.workloads import REF_TESTS
    if not os.path.exists(os.path.join(REF_TESTS, "dilute", "data")):
        pytest.skip(f"reference decks not found under {REF_TESTS} "
                    "(set CONP_REF_TESTS)")


@pytest.fixture(scope="session")
def gpu():
    """The first GPU; skips when JAX has none (run these tests on the card
    with JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU")
    return gpus[0]
