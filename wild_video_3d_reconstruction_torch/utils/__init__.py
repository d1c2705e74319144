from .config import DPVOConfig, load_config
