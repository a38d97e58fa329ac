"""The benchmark harness of the port: scene, driver, spans, trace,
roofline and the comparison that decides ``correct``."""
