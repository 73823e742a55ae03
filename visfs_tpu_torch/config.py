"""Configuration registry of visfs_tpu_torch (its own copy of
visfs_tpu.config, held equal key by key by tests/test_torch_system_lk.py).

Mirrors the reference's compile-time ``VISFS_PARAM`` registry
(corelib/include/Parameters.h:140-198): same group/name keys, same defaults,
same descriptions — exposed both as a typed frozen dataclass and as a
string-keyed map with typed parsing (``Parameters::parse``,
corelib/src/Parameters.cpp:40-101) so launch / YAML-style overrides keep
working.  Tracker/FlowRegionExtract and Tracker/FlowUnroll select TPU
lowerings of one LK formulation; this package accepts and ignores them
(``ops.lk.LKParams.from_config``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

# (group, name, python type, default, description)
_REGISTRY: Tuple[Tuple[str, str, type, Any, str], ...] = (
    ("System", "SensorStrategy", int, 0,
     "System use sensors type: 0 stereo, 1 rgbd, 2 stereo + wheel, "
     "3 stereo + laser + wheel, 4 laser + wheel, 5 laser"),
    ("System", "WheelOdometryFreq", int, 100, "The frequence of wheel odometry."),
    ("System", "Monitor", bool, False, "Monitor"),
    ("System", "CLAHE", bool, False, "CLAHE"),
    ("System", "LogLevel", int, 1, "0-DEBUG, 1-INFO, 2-WARN, 3-ERROR, 5-FATAL"),
    ("System", "LogOnConsole", bool, False, "Display the log on the console."),
    ("System", "LogFolder", str, "~/.VISFS/logs", ""),

    ("Tracker", "MaxFeatures", int, 300,
     "The maximum number of key points will be generated."),
    ("Tracker", "QualityLevel", float, 0.01, ""),
    ("Tracker", "MinDistance", int, 40, ""),
    ("Tracker", "FlowBack", bool, True,
     "Perform backward optical flow to improve feature tracking accuracy."),
    ("Tracker", "MaxDepth", float, 10.0,
     "Max depth of the features (0 means no limit)."),
    ("Tracker", "MinDepth", float, 0.2,
     "Min depth of the features (0 means no limit)."),
    ("Tracker", "FlowWinSize", int, 21,
     "Size of the search window at each pyramid level."),
    ("Tracker", "FlowIterations", int, 30,
     "Termination criteria of the max interation times."),
    ("Tracker", "FlowEps", float, 0.01,
     "Termination criteria of the search window moves by less than "
     "criteria.epsilon"),
    ("Tracker", "FlowMaxLevel", int, 3,
     "Maximal pyramid level number; if set to 0, pyramids are not used "
     "(single level)"),
    ("Tracker", "FlowRegionExtract", str, "auto",
     "TPU-native extension (no reference analogue): how LK pulls patch "
     "regions from the level images — 'matmul' (one-hot selector "
     "contractions; best single-stream latency), 'gather' (one DMA row "
     "gather; best fleet/batched throughput), or 'auto' (matmul for "
     "System, gather for FleetSystem)."),
    ("Tracker", "FlowComputeDtype", str, "float32",
     "TPU-native extension (no reference analogue): dtype of the LK "
     "pyramid/patch-sampling math — 'float32' (exact reference semantics) "
     "or 'bfloat16' (MXU-native-rate sampling, ~0.4% pixel rounding; "
     "coordinates, G statistics and flow stay float32)."),
    ("Tracker", "FlowUnroll", int, 3,
     "TPU-native extension (no reference analogue): LK iterations per "
     "while-loop step.  >= FlowIterations turns the loop into a fully "
     "static chain (no early-exit bookkeeping, maximal async pipelining); "
     "converged features' updates are masked so semantics never change."),
    ("Tracker", "CullByFundationMatrix", bool, False,
     "Use fundation matrix to cull out the outliers in the result of "
     "feature match."),
    ("Tracker", "FundationPixelError", float, 1.0,
     "Threshold of fundation matrix calculate error."),

    ("LocalMap", "MapSize", int, 5,
     "The size of Local map. The value means the quantity of signatures "
     "that we are estimating."),
    ("LocalMap", "MinParallax", float, 60.0,
     "Keysignature selection threshold (pixel)."),
    ("LocalMap", "MinTranslation", float, 0.5,
     "Min distance condition to judge key signature."),
    ("LocalMap", "NumRangeDataLimit", int, 50,
     "The number of range data will be inserted to submap."),
    ("LocalMap", "GridMapType", int, 0, "0-ProbabilityGrid, 1-TSDF."),
    ("LocalMap", "MapResolution", float, 0.05, "The resolution of the map."),
    ("LocalMap", "InsertFreeSpace", bool, True,
     "Fill the space in map automatically."),
    ("LocalMap", "HitProbability", float, 0.55, ""),
    ("LocalMap", "MissProbability", float, 0.49, ""),

    ("Estimator", "MinInliers", int, 12, "Minimal inliers between two images."),
    ("Estimator", "PnPIterations", int, 50, "Maximal interation times in ransac."),
    ("Estimator", "PnPReprojError", float, 2.0, "PnP reprojection error."),
    ("Estimator", "PnPFlags", int, 1, "PnP flags: 0=Iterative, 1=EPNP, 2=P3P."),
    ("Estimator", "RefineIterations", int, 5,
     "Number of iterations used to refine the transformation found by "
     "RANSAC. 0 means that the transformation is not refined."),
    ("Estimator", "ToleranceTranslation", float, 0.32,
     "The max translation percentage difference between all sensors. The "
     "lower, we trust other sensor more."),
    ("Estimator", "ToleranceRotation", float, 0.40,
     "The max rotation percentage difference between all sensors. The "
     "lower, we trust other sensor more."),
    ("Estimator", "Force3DoF", bool, False,
     "Force 3 degrees-of-freedom transform (3Dof: x,y and yaw). Parameters "
     "z, roll and pitch will be set to 0."),
    ("Estimator", "NumSubDivisionPreScan", int, 5,
     "The numbers of division parts for each complete laser scan."),
    ("Estimator", "MinLaserRange", float, 0.1,
     "The minimum range the laser is avaliable."),
    ("Estimator", "MaxLaserRange", float, 30.0,
     "The maximum range the laser is avaliable."),
    ("Estimator", "MissingDataRayLength", float, 5.0,
     "The cast ray length of missing data."),

    ("Optimizer", "Framework", int, 0,
     "Kept for API parity; the TPU engine has a single JAX GN/LM solver "
     "(reference: 0=g2o, 1=ceres)."),
    ("Optimizer", "Solver", int, 0,
     "Linear solver selector, parity key (TPU engine: dense Schur + Cholesky)."),
    ("Optimizer", "TrustRegion", int, 0, "0=Levenberg 1=GaussNewton."),
    ("Optimizer", "Iterations", int, 10, "Optimization iterations."),
    ("Optimizer", "PixelVariance", float, 1.5,
     "Pixel variance used for bundle adjustment."),
    ("Optimizer", "OdometryCovariance", float, 0.00005,
     "Odometry covaraince used for local optimize."),
    ("Optimizer", "LaserCovariance", float, 0.1,
     "Laser covariance used for local optimize."),
    ("Optimizer", "RobustKernelDelta", float, 8.0,
     "Robust kernel delta used for bundle adjustment (0 means don't use "
     "robust kernel). Observations with chi2 over this threshold will be "
     "ignored in the second optimization pass."),

    ("Map", "2dNumRangeData", int, 90,
     "The limits used to insert range data into new submaps, when reaches "
     "the limits, the new map will use to scan-match, the old need to "
     "destory."),
    ("Map", "2dGridType", int, 0, "0=Probability map."),
    ("Map", "2dResolution", float, 0.05, "The resolution of the map"),
    ("Map", "2dInsertFreeSpace", bool, True,
     "Automatic insert the free status between origin and hit."),
    ("Map", "2dHitProbability", float, 0.55, ""),
    ("Map", "2dMissProbability", float, 0.49, ""),
)

DEFAULT_PARAMETERS: Dict[str, Any] = {
    f"{g}/{n}": d for (g, n, _, d, _) in _REGISTRY
}
PARAMETER_TYPES: Dict[str, type] = {f"{g}/{n}": t for (g, n, t, _, _) in _REGISTRY}
PARAMETER_DESCRIPTIONS: Dict[str, str] = {
    f"{g}/{n}": desc for (g, n, _, _, desc) in _REGISTRY
}


def parse_value(key: str, value: Any) -> Any:
    """Typed parse of one parameter (Parameters.cpp:40-101 equivalent)."""
    if key not in PARAMETER_TYPES:
        raise KeyError(f"Unknown VISFS parameter: {key!r}")
    ty = PARAMETER_TYPES[key]
    if ty is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    return ty(value)


def _field_name(group: str, name: str) -> str:
    out = []
    for i, ch in enumerate(group + "_" + name):
        if ch.isupper() and i > 0 and out[-1] != "_":
            out.append("_")
        out.append(ch.lower())
    s = "".join(out).replace("__", "_")
    # Tidy acronyms for readable field names.
    for src, dst in (
        ("c_l_a_h_e", "clahe"),
        ("pn_p", "pnp"),
        ("force3_do_f", "force_3dof"),
    ):
        s = s.replace(src, dst)
    return s


# Build the frozen dataclass dynamically from the registry so field defaults
# can never drift from the string-keyed registry.
def _make_config_class():
    fields = []
    key_by_field = {}
    for (g, n, t, d, _) in _REGISTRY:
        fname = _field_name(g, n)
        if fname[0].isdigit():
            fname = "map_" + fname
        fields.append((fname, t, dataclasses.field(default=d)))
        key_by_field[fname] = f"{g}/{n}"
    cls = dataclasses.make_dataclass(
        "VISFSConfig", fields, frozen=True, eq=True,
        namespace={"_KEY_BY_FIELD": key_by_field},
    )
    return cls


VISFSConfig = _make_config_class()
_FIELD_BY_KEY = {v: k for k, v in VISFSConfig._KEY_BY_FIELD.items()}


def config_from_parameters(params: Mapping[str, Any] | None = None) -> "VISFSConfig":
    """Build a VISFSConfig from a string-keyed override map (rosparam-style).

    Unknown keys raise, matching the validation in InterfaceROS.cpp:125-155.
    ``Estimator/MinInliers`` is floored at 8 like the ROS layer does
    (InterfaceROS.cpp:147-150).
    """
    kwargs: Dict[str, Any] = {}
    if params:
        for key, value in params.items():
            field = _FIELD_BY_KEY.get(key)
            if field is None:
                raise KeyError(f"Unknown VISFS parameter: {key!r}")
            kwargs[field] = parse_value(key, value)
    cfg = VISFSConfig(**kwargs)
    if cfg.estimator_min_inliers < 8:
        cfg = dataclasses.replace(cfg, estimator_min_inliers=8)
    return cfg


def config_to_parameters(cfg: "VISFSConfig") -> Dict[str, Any]:
    return {
        cfg._KEY_BY_FIELD[f.name]: getattr(cfg, f.name)
        for f in dataclasses.fields(cfg)
    }
