from .checkpoint import load_run_params, params_from_flax, read_msgpack

__all__ = ["load_run_params", "params_from_flax", "read_msgpack"]
