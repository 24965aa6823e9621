"""Loop closure (port of direct_stereo_slam_tpu/loop): imitated-LiDAR scans,
Scan Context retrieval, direct / ICP loop pose, and the SE(3) pose graph."""
