"""Inference of the port: `engine` (whole, slide and aug-test on a model),
`slide`, `outputs` (the fetch policies), `server` (HTTP) and `exported`
(serving an exported program).  Nothing is imported here, so that
`infer.exported` loads a bundle without the model code."""
