from .prepare import generate_nf_transform
from .train import run_ns_train, train_clips
