"""The SLAM runtime: tracker, mapper, the per-frame System and the Fuser."""
