# Deployment image — Grand-Challenge algorithm contract.
# Mirrors the reference packaging (reference Dockerfile:1-93): a CUDA base,
# non-root user, /input + /output mount points, processor.py entrypoint,
# resource labels (1 GPU with 8 GB).  JAX brings its CUDA libraries as
# pip wheels (jax[cuda12]); the base supplies the user-space driver glue.
FROM nvidia/cuda:12.8.1-base-ubuntu24.04

RUN apt-get update \
    && apt-get install -y --no-install-recommends python3 python3-venv \
    && rm -rf /var/lib/apt/lists/* \
    && groupadd -r algorithm && useradd -m --no-log-init -r -g algorithm algorithm \
    && mkdir -p /opt/algorithm /input /output \
    && chown algorithm:algorithm /opt/algorithm /input /output

USER algorithm
WORKDIR /opt/algorithm
RUN python3 -m venv /home/algorithm/venv
ENV PATH="/home/algorithm/venv/bin:${PATH}"

RUN python -m pip install -U pip

COPY --chown=algorithm:algorithm install_files/requirements.txt /opt/algorithm/
RUN python -m pip install -r requirements.txt

COPY --chown=algorithm:algorithm bodyct_dram_emph_subtype/ /opt/algorithm/bodyct_dram_emph_subtype/
COPY --chown=algorithm:algorithm conf/ /opt/algorithm/conf/
COPY --chown=algorithm:algorithm processor.py train.py test.py bench.py /opt/algorithm/
# model weights: torch best.ckpt (imported greedily) or a train checkpoint dir
# COPY --chown=algorithm:algorithm best.ckpt /opt/algorithm/

ENTRYPOINT ["python", "-m", "processor"]

## ALGORITHM LABELS ##
LABEL nl.diagnijmegen.rse.algorithm.name=dram_emph_subtype
LABEL nl.diagnijmegen.rse.algorithm.hardware.cpu.count=2
LABEL nl.diagnijmegen.rse.algorithm.hardware.memory=32G
LABEL nl.diagnijmegen.rse.algorithm.hardware.gpu.count=1
LABEL nl.diagnijmegen.rse.algorithm.hardware.gpu.memory=8G
