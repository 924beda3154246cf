"""Meta-test: the public-function registry and the package exports agree
(the reference enforces its @doc type: taxonomy the same way;
test/support/nx_signal_case.ex:19-39)."""

import importlib

from nx_signal_tpu.registry import FUNCTION_TYPES, TAXONOMY, function_type

# Exempt from registration: types/containers/constants re-exported for
# convenience.
_EXEMPT = {"STFTResult", "Extrema", "GaussianPulse", "CHANNEL_AXIS", "BLOCK_AXIS"}


def test_all_categories_valid():
    for module, functions in FUNCTION_TYPES.items():
        for name, category in functions.items():
            assert category in TAXONOMY, (
                f"{module}.{name} has invalid category {category!r}"
            )


def test_registered_functions_exist():
    for module, functions in FUNCTION_TYPES.items():
        mod = importlib.import_module(f"nx_signal_tpu.{module}")
        for name in functions:
            assert hasattr(mod, name), f"registered {module}.{name} does not exist"


def test_every_public_export_is_registered():
    for module in FUNCTION_TYPES:
        mod = importlib.import_module(f"nx_signal_tpu.{module}")
        for name in getattr(mod, "__all__", []):
            if name in _EXEMPT:
                continue
            assert function_type(module, name) is not None, (
                f"public export {module}.{name} is not registered in "
                "nx_signal_tpu.registry.FUNCTION_TYPES"
            )


def test_registered_functions_have_docstrings():
    for module, functions in FUNCTION_TYPES.items():
        mod = importlib.import_module(f"nx_signal_tpu.{module}")
        for name in functions:
            obj = getattr(mod, name)
            assert (obj.__doc__ or "").strip(), f"{module}.{name} has no docstring"


def test_every_registered_export_has_executed_examples():
    """Every public
    export carries a `>>>` example (the reference's doctests-as-spec
    discipline, SURVEY §4.1). The doctest runner executes them; this
    guards against NEW exports landing without one."""
    import inspect

    missing = []
    for module, functions in FUNCTION_TYPES.items():
        mod = importlib.import_module(f"nx_signal_tpu.{module}")
        for name in functions:
            doc = inspect.getdoc(getattr(mod, name)) or ""
            if ">>>" not in doc:
                missing.append(f"{module}.{name}")
    assert not missing, f"exports without doc examples: {missing}"
