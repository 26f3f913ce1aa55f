"""Offline data factory: multi-traversal LiDAR registration and the
preprocessing stage pipeline; port of `mtgs_tpu/preprocess/` (counterpart
of `nuplan_scripts/` in OpenDriveLab/MTGS). Host code apart from the
point-cloud stacking, which runs on the card."""
