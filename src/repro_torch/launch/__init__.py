# Port of src/repro/launch/: the multi-tenant SpMM serving endpoint and its
# continuous-batching scheduler (launch/serve.py).
