// The head dims both flash sources build: flash_attention.cu (mma_sync) and
// flash_attention_sm90.cu (wgmma). ops/flash_attention.py's SM90_TILES keys
// list the same ones: 64 (TinyLlama), 80 (phi-2, Pythia-2.8B), 96
// (phi-3-mini), 128 (Llama-2) and 256 (Pythia-1B, GPT-J).

#pragma once

#define FLASH_HEAD_DIMS(X) X(64) X(80) X(96) X(128) X(256)
