# Convenience targets; the Python package also builds the native library
# on demand (ribbit_tpu/native.py) so none of this is required.

CC ?= cc
CFLAGS ?= -O3 -march=native -shared -fPIC -pthread
SRCS = csrc/ribbit_core.c csrc/ribbit_refine.c csrc/ribbit_align.c \
       csrc/ribbit_vote.c

.PHONY: all native asan tsan ubsan oracle test bench clean

all: native

native: build/ribbit_native.so

build/ribbit_native.so: $(SRCS)
	mkdir -p build
	$(CC) $(CFLAGS) $(SRCS) -o $@ -lm

# AddressSanitizer build installed under the loader's cache name; run any
# workload with LD_PRELOAD=$$(cc -print-file-name=libasan.so).  The core is
# ASAN-clean on all parity fixtures (remaining leak reports are CPython
# interpreter-lifetime objects).
asan:
	mkdir -p build
	$(CC) -O1 -g -fsanitize=address -march=native -shared -fPIC -pthread \
	    $(SRCS) -o build/ribbit_asan.so -lm
	python -c "import hashlib,pathlib,shutil; \
	    files=['ribbit_core.c','ribbit_refine.c','ribbit_align.c','ribbit_vote.c']; \
	    h=hashlib.sha256(b''.join((pathlib.Path('csrc')/f).read_bytes() for f in files)).hexdigest()[:16]; \
	    shutil.copy('build/ribbit_asan.so', f'build/ribbit_core_{h}.so')"

# ThreadSanitizer build (same install scheme; LD_PRELOAD libtsan.so).
# The threaded generation/refinement pools are TSAN-clean on all fixtures.
# -mno-avx512f: GCC's tsan instrumentation has miscompiled AVX-512
# compare-mask loops under concurrency (wrong results with ZERO race
# reports; plain/ASan/UBSan/serial-tsan all agreed) — TSan runs exercise
# the same algorithms through the portable paths.
tsan:
	mkdir -p build
	$(CC) -O1 -g -fsanitize=thread -march=native -mno-avx512f -shared \
	    -fPIC -pthread $(SRCS) -o build/ribbit_tsan.so -lm
	python -c "import hashlib,pathlib,shutil; \
	    files=['ribbit_core.c','ribbit_refine.c','ribbit_align.c','ribbit_vote.c']; \
	    h=hashlib.sha256(b''.join((pathlib.Path('csrc')/f).read_bytes() for f in files)).hexdigest()[:16]; \
	    shutil.copy('build/ribbit_tsan.so', f'build/ribbit_core_{h}.so')"

# UndefinedBehaviorSanitizer build (same install scheme; LD_PRELOAD
# libubsan.so).  Clean (-fno-sanitize-recover) on all fixtures + 1Mb.
ubsan:
	mkdir -p build
	$(CC) -O1 -g -fsanitize=undefined -fno-sanitize-recover=undefined \
	    -march=native -shared -fPIC -pthread $(SRCS) -o build/ribbit_ubsan.so -lm
	python -c "import hashlib,pathlib,shutil; \
	    files=['ribbit_core.c','ribbit_refine.c','ribbit_align.c','ribbit_vote.c']; \
	    h=hashlib.sha256(b''.join((pathlib.Path('csrc')/f).read_bytes() for f in files)).hexdigest()[:16]; \
	    shutil.copy('build/ribbit_ubsan.so', f'build/ribbit_core_{h}.so')"

oracle:
	bash tools/oracle/build.sh

test: native
	python -m pytest tests/ -q

bench: native
	python bench.py

clean:
	rm -rf build
