"""The repo's deployment operating points as literals: the ``visfs:``
blocks of configs/sim_mapping.yaml (full-fusion mapping, SensorStrategy 3
with CLAHE) and configs/sim_localization.yaml (stereo-only localization,
FlowBack off) as parameter dicts, and their ``node:`` and ``frames:``
blocks (the adapter's options and the static frame tree), key for key, so
that they load where yaml is not installed.  ``operating_point(name)``
assembles an ``io.adapter.OperatingPoint`` from them.
tests/test_torch_operating_points.py holds them equal to the files."""

# configs/sim_mapping.yaml, visfs:
SIM_MAPPING = {
    "System/SensorStrategy": 3,
    "System/Monitor": True,
    "System/CLAHE": True,
    "System/LogLevel": 1,
    "System/LogOnConsole": True,
    "Tracker/MaxFeatures": 120,
    "Tracker/QualityLevel": 0.05,
    "Tracker/MinDistance": 40,
    "Tracker/FlowBack": True,
    "Tracker/CullByFundationMatrix": False,
    "Tracker/FlowWinSize": 21,
    "LocalMap/MapSize": 5,
    "LocalMap/MinParallax": 60.0,
    "LocalMap/MinTranslation": 0.5,
    "LocalMap/NumRangeDataLimit": 60,
    "Estimator/PnPFlags": 1,
    "Estimator/PnPReprojError": 2,
    "Estimator/ToleranceTranslation": 0.4,
    "Estimator/ToleranceRotation": 0.4,
    "Estimator/Force3DoF": True,
    "Estimator/NumSubDivisionPreScan": 1,
    "Estimator/MinLaserRange": 0.1,
    "Estimator/MaxLaserRange": 30.0,
    "Estimator/MissingDataRayLength": 5.0,
    "Optimizer/Framework": 0,
    "Optimizer/Solver": 0,
    "Optimizer/TrustRegion": 0,
    "Optimizer/Iterations": 20,
    "Optimizer/PixelVariance": 1.5,
    "Optimizer/OdometryCovariance": 4e-05,
    "Optimizer/LaserCovariance": 0.1,
    "Optimizer/RobustKernelDelta": 10.0,
}

# configs/sim_localization.yaml, visfs:
SIM_LOCALIZATION = {
    "System/SensorStrategy": 0,
    "System/Monitor": False,
    "Tracker/MaxFeatures": 200,
    "Tracker/FlowBack": False,
    "Estimator/PnPFlags": 1,
    "Estimator/PnPReprojError": 2,
    "Estimator/Force3DoF": True,
}

# configs/sim_mapping.yaml, node:
SIM_MAPPING_NODE = {
    "subscribe_wheel_odom": True,
    "subscribe_laser_scan": True,
    "approx_sync": True,
    "queue_size": 10,
    "camera_frame_id": "camera_link",
    "laser_frame_id": "sick_laser_link",
    "robot_frame_id": "base_link",
    "odom_frame_id": "odom",
    "publish_tf": False,
    "base_line": 0.0502569,
}

# configs/sim_mapping.yaml, frames:
SIM_MAPPING_FRAMES = {
    "camera_link": {"parent": "base_link", "xyz": [0.0, 0.0, 0.68],
                    "rpy": [0.0, 0.0, 0.0]},
    "sick_laser_link": {"parent": "base_link",
                        "xyz": [0.09375, 0.0, 0.0711],
                        "rpy": [0.0, 0.0, 0.0]},
}

# configs/sim_localization.yaml, node: (it has no frames: block)
SIM_LOCALIZATION_NODE = {
    "subscribe_wheel_odom": False,
    "subscribe_laser_scan": False,
    "approx_sync": True,
    "queue_size": 10,
    "camera_frame_id": "camera_link",
    "robot_frame_id": "base_link",
    "odom_frame_id": "odom",
    "publish_tf": False,
    "base_line": 0.0502569,
}
SIM_LOCALIZATION_FRAMES = {}

_POINTS = {
    "sim_mapping": (SIM_MAPPING_NODE, SIM_MAPPING, SIM_MAPPING_FRAMES),
    "sim_localization": (SIM_LOCALIZATION_NODE, SIM_LOCALIZATION,
                         SIM_LOCALIZATION_FRAMES),
}


def operating_point(name: str):
    """configs/<name>.yaml as an io.adapter.OperatingPoint (fresh copies of
    the literals, so a caller may override keys)."""
    import copy

    from .io.adapter import OperatingPoint

    node, visfs, frames = _POINTS[name]
    return OperatingPoint(node=dict(node), visfs=dict(visfs),
                          frames=copy.deepcopy(frames))
