from .convert import jax_disc_params_to_state_dict, jax_params_to_state_dict
from .device import resolve_device

__all__ = ["jax_disc_params_to_state_dict", "jax_params_to_state_dict", "resolve_device"]
