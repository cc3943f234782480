"""Demos of the port: detection on image files and on a webcam stream."""
