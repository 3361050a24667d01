# Generation + deploy pipeline (reference surface: Makefile:62-91 —
# `make generate` -> `make upload` (S3 sync) -> `make deploy` (promote
# widget to index.html + CloudFront invalidation)).

PYTHON      ?= python
IMG         ?= example/source.jpg
TILES_DIR   ?= tiles
OUTPUT_DIR  ?= output
OUTPUT      ?= $(OUTPUT_DIR)/mosaic.jpg
TILE_SIZE   ?= 32
MODE        ?= 32
TITLE       ?= Mosaic Widget
EXTENSIONS  ?= jpg JPG jpeg JPEG
S3_BUCKET   ?=
CLOUDFRONT_DISTRIBUTION_ID ?=

.PHONY: generate upload deploy test smoke native clean

generate:
	mkdir -p $(OUTPUT_DIR)
	$(PYTHON) -m emosaic_tpu.cli \
		-s $(TILE_SIZE) -o $(OUTPUT) $(IMG) --crop \
		mosaic $(TILES_DIR) -m $(MODE) --no-repeat --web \
		--title "$(TITLE)" --extensions $(EXTENSIONS)

upload:
	test -n "$(S3_BUCKET)" || (echo "set S3_BUCKET"; exit 1)
	aws s3 sync $(OUTPUT_DIR) s3://$(S3_BUCKET)/ --exclude "*.stats.png"
	aws s3 sync $(TILES_DIR) s3://$(S3_BUCKET)/tiles/

deploy: upload
	test -n "$(S3_BUCKET)" || (echo "set S3_BUCKET"; exit 1)
	aws s3 cp s3://$(S3_BUCKET)/$(notdir $(basename $(OUTPUT)))_widget.html \
		s3://$(S3_BUCKET)/index.html
	test -z "$(CLOUDFRONT_DISTRIBUTION_ID)" || \
		aws cloudfront create-invalidation \
			--distribution-id $(CLOUDFRONT_DISTRIBUTION_ID) --paths "/*"

native:
	$(MAKE) -C native

test:
	$(PYTHON) -m pytest tests/ -x -q

smoke:
	$(PYTHON) chip_smoke.py

clean:
	rm -rf $(OUTPUT_DIR) native/*.so native/*.o
