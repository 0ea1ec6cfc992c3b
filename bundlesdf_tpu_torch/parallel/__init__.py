"""More than one video at a time (`videos.py`)."""
from bundlesdf_tpu_torch.parallel.videos import run_videos_parallel

__all__ = ["run_videos_parallel"]
