"""The SLAM runtime of one submap: tracker, mapper and the per-frame loop."""
