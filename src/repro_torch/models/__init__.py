"""Model code of the port: calibration forward, fold, integer serving forward."""
