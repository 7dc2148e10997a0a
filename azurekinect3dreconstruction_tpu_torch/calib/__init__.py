"""Camera-rig calibration."""
