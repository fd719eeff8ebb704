"""Datasets: host-side numpy samplers of fixed-shape batches.

Synthetic: ``sdf_3d`` (``Sdf3D``, ``PosedSdf3D`` and their batched
wrappers), ``sdf_2d`` (``Sdf2D``, from an occupancy image), ``sequence``
(``SdfSequence``), ``sdf_3d_submap`` (``SubmapSdf3D``), ``rgbd``
(``SyntheticRgbd``).  On-disk: ``rgbd``
(``PosedSdfRgbd``), ``scannet`` (``ScanNet``), ``replica`` (``ReplicaCAD``),
``fastcamo`` (``FastCaMo``), ``lidar`` (``PosedSdf3DLidar``)."""
