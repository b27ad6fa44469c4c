"""Calibration-file and parameter IO."""
