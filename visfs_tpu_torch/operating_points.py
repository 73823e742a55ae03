"""The repo's deployment operating points as parameter dicts: the
``visfs:`` blocks of configs/sim_mapping.yaml (full-fusion mapping,
SensorStrategy 3 with CLAHE) and configs/sim_localization.yaml
(stereo-only localization, FlowBack off), key for key, as literals so that
they load where yaml is not installed.  tests/test_torch_operating_points.py
holds them equal to the files."""

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
