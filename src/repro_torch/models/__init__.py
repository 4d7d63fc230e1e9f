"""Language models of the port: config, params, layers, GQA attention,
Mamba-2 and the model stack (the serving path of :mod:`repro.models`)."""
