from .config import ModelConfig, config_from_header
from .params import KVCache, LayerParams, ModelParams, init_kv_cache, load_params, params_from_jax
from .transformer import forward
