# The paper's primary contribution — compressed key sort + fast index
# reconstruction — in PyTorch: key formats, distinction bits, extraction
# plans, DS-metadata, the partial-key B+tree and the pipeline.  Modules are
# imported where they are used (the pipeline imports the backends, which
# import these modules back).
