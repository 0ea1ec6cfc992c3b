"""More than one device: ray data parallelism for the NOF (`dp.py`) and
more than one video at a time (`videos.py`)."""
from bundlesdf_tpu_torch.parallel.dp import (grads_on_batch_dp,
                                             make_ray_devices, shard_batch,
                                             shard_rays, train_steps_dp)
from bundlesdf_tpu_torch.parallel.videos import run_videos_parallel

__all__ = ["grads_on_batch_dp", "make_ray_devices", "run_videos_parallel",
           "shard_batch", "shard_rays", "train_steps_dp"]
