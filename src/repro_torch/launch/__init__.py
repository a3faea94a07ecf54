"""Launch layer of the port: the H100's constants, the analytic cost
model, the roofline table and the serving launcher."""
