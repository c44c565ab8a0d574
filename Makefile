.PHONY: test bench smoke native clean

test:
	python -m pytest tests/ -q

bench:
	python bench.py

smoke:
	python chip_smoke.py

native:
	python -c "from cvsim_tpu import native; from cvsim_tpu.native import hostpix; native._load(); hostpix._load(); native.build_av_tool()"

clean:
	rm -rf .jax_cache .bench_scalar_baseline .bench_scalar_baseline.key \
	    cvsim_tpu/native/libhostio.so cvsim_tpu/native/libhostpix.so \
	    cvsim_tpu/native/cvsim-av cvsim_tpu/native/*.key \
	    $(shell find . -name __pycache__ -type d)
