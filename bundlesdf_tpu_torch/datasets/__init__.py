"""Dataset readers (ref `BundleTrack/scripts/data_reader.py`)."""
from bundlesdf_tpu_torch.datasets.readers import Ho3dReader, YcbineoatReader
