"""The port's public names: every name in a JAX package ``__all__`` is in
the port's counterpart and resolves there, except the deliberate
omissions below, each with its ROADMAP reason (Queue A, "Deliberately not
ported").
"""

import importlib

import pytest

# JAX name -> why the port leaves it out
OMITTED = {
    "vargp_tpu.train": {
        "make_update_fn": "scan_epoch=False (one dispatch per minibatch) is not ported",
    },
    "vargp_tpu.ops": {
        "get_backend": "the port dispatches by the tensors' device, not a backend knob",
        "set_backend": "the port dispatches by the tensors' device, not a backend knob",
    },
    "vargp_tpu.gpmath": {
        name: "the filled tril layout, a TPU gather workaround, is not ported"
        for name in ("filled_perm", "filled_to_rowmajor", "rowmajor_to_filled",
                     "tril_from_filled")
    },
}
PACKAGES = ["vargp_tpu", "vargp_tpu.models", "vargp_tpu.utils", "vargp_tpu.train",
            "vargp_tpu.ops", "vargp_tpu.gpmath", "vargp_tpu.kernels", "vargp_tpu.likelihoods",
            "vargp_tpu.data", "vargp_tpu.parallel"]


@pytest.mark.parametrize("jax_name", PACKAGES)
def test_jax_public_names_are_the_ports(jax_name):
    jmod = importlib.import_module(jax_name)
    tmod = importlib.import_module(jax_name.replace("vargp_tpu", "vargp_tpu_torch", 1))
    omitted = OMITTED.get(jax_name, {})
    want = set(jmod.__all__) - set(omitted)
    assert want <= set(tmod.__all__), sorted(want - set(tmod.__all__))
    for name in tmod.__all__:
        assert hasattr(tmod, name), name
    # an omission is a name the port really lacks
    assert not set(omitted) & set(tmod.__all__)


def test_port_modules_export_the_same_kind_of_object():
    """Submodules stay submodules and functions functions."""
    import types

    import vargp_tpu_torch as T
    import vargp_tpu_torch.models as TM

    for name in ("gpmath", "kernels", "likelihoods", "models", "train", "data"):
        assert isinstance(getattr(T, name), types.ModuleType), name
    for name in ("vargp", "global_svgp", "vargp_retrain"):
        assert isinstance(getattr(TM, name), types.ModuleType), name
    assert T.__version__ == importlib.import_module("vargp_tpu").__version__


def test_docstrings_name_what_the_packages_hold():
    import vargp_tpu_torch.models as TM
    import vargp_tpu_torch.utils as TU

    assert "non-DKL" not in TM.__doc__ and "global_svgp" in TM.__doc__
    assert TU.__doc__.strip() != "Conversion helpers." and "checkpoint" in TU.__doc__
