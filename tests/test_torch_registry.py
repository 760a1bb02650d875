"""The port's registry (humangaussian_torch/registry.py) against the JAX
package's: the same names, each resolving to the port's counterpart."""
import pytest

from humangaussian_torch import registry
from humangaussian_tpu import registry as jax_registry


def test_names_equal_the_jax_registry():
    assert registry.names() == jax_registry.names()


@pytest.mark.parametrize("name", jax_registry.names())
def test_every_jax_name_resolves_to_the_port(name):
    obj = registry.find(name)
    want = jax_registry.find(name)
    assert obj.__module__.startswith("humangaussian_torch.")
    assert obj.__name__ == want.__name__
    assert obj.__module__.split(".")[1:] == want.__module__.split(".")[1:]


def test_register_and_duplicates():
    @registry.register("port-test-component")
    class Component:
        pass

    try:
        assert registry.find("port-test-component") is Component
        registry.register("port-test-component")(Component)  # same: ok
        with pytest.raises(ValueError):
            registry.register("port-test-component")(type("Other", (), {}))
        with pytest.raises(KeyError):
            registry.find("no-such-component")
    finally:
        registry._REGISTRY.pop("port-test-component")
