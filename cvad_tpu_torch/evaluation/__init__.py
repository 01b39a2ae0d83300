"""Evaluation: video scoring (windows, streams, frame AUC), the scorers of
every family, metrics, the batching service and its HTTP front-end, the
person detectors, bbox localization and reports, and the plots."""
