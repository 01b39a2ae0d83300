"""Evaluation: video scoring (windows, streams, frame AUC), family-D and
family-B scorers, metrics, the batching service and its HTTP front-end."""
