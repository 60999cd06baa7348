# Convenience targets (the reference ships a Makefile of 11 renderer
# binaries, Makefile:1-41; here variants are runtime flags, so the targets
# are workflows).

.PHONY: test native bench smoke gallery realtime clean

native:
	$(MAKE) -C native

test:
	python -m pytest tests/ -q

bench:
	python bench.py

smoke:
	python chip_smoke.py

gallery:
	python -m raytracinggpu.cli render 32 5 --preset array_bvh \
	    --out gallery/array_bvh.png

realtime:
	python -m raytracinggpu.cli realtime --frames 30 --out-dir gallery/frames

clean:
	$(MAKE) -C native clean
	rm -rf .pytest_cache
