from .colmap_init import run_colmap_initialization
from .prior_init import anchor_first_frame, init_from_prior
