"""Models of the port: transfer net, style predictor, inference graph."""
